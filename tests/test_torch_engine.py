"""The port's fused driver (``run_pallas``) against the JAX package's.

Both sides start from the same graph, the same initial ranks and the same
affected set (numpy, from a seed); the JAX side runs its XLA tile backend,
the port its plain kernels on the CPU.  The counters — sweeps, iterations,
blocks, edges, converged, dnf — must be EQUAL (the driver's control flow is
the reference's, gated sweep for sweep); the simulated time is an f32 sum
of the same terms (rel 1e-6); ranks must agree within L∞ ≤ 1e-9 in f64 (the
two sides differ only in summation order, ~1e-18 here).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import faults as jflt
from repro.core import pallas_engine as jpe
from repro.graphs import generators as jgen
from repro_torch.core import faults as tflt
from repro_torch.core import pallas_engine as tpe
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.incremental import IncrementalPullMatrix

# f32 products stay IEEE on the card (no TF32), as in the JAX tests
torch.backends.cuda.matmul.allow_tf32 = False

COUNTERS = ("sweeps", "iterations", "blocks_processed", "edges_processed",
            "converged", "dnf")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind, seed=0):
    if kind == "grid":
        jg = jgen.grid_road(24, seed=seed)
    else:
        jg = jgen.rmat(9, avg_degree=6, seed=seed)
    tg = THostGraph(jg.n, jg.edges)
    gj, gt = jg.snapshot(block_size=32), tg.snapshot(block_size=32,
                                                     device="cpu")
    rng = np.random.default_rng(seed + 1)
    r0 = rng.random(gj.n_pad)
    r0[gj.n:] = 0
    r0 /= r0.sum()
    aff = rng.random(gj.n_pad) < 0.02
    return gj, gt, r0, aff


def _both(gj, gt, r0, aff, jplan=None, tplan=None, **kw):
    Rj, sj = jpe.run_pallas(gj, jnp.asarray(r0), jnp.asarray(aff),
                            backend="xla", faults=jplan, **kw)
    Rt, st = tpe.run_pallas(gt, torch.from_numpy(r0), torch.from_numpy(aff),
                            faults=tplan, **kw)
    return np.asarray(Rj), sj, Rt.numpy(), st


def _assert_same(Rj, sj, Rt, st):
    for c in COUNTERS:
        assert getattr(st, c) == getattr(sj, c), c
    np.testing.assert_allclose(st.sim_time_ms, sj.sim_time_ms, rtol=1e-6)
    assert np.abs(Rt - Rj).max() <= 1e-9


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("policy", ["affected", "rc"])
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("kind", ["grid", "rmat"])
def test_run_pallas_matches_jax(kind, mode, policy, expand):
    gj, gt, r0, aff = _problem(kind)
    out = _both(gj, gt, r0, aff, mode=mode, active_policy=policy,
                expand=expand, tau=1e-10)
    _assert_same(*out)
    assert out[3].converged


def test_all_affected_solve_matches_jax():
    """The cold solve's shape (every vertex affected, no expansion) — the
    port's full-list kernel path — from the uniform start."""
    gj, gt, _, _ = _problem("grid", seed=3)
    r0 = np.where(np.arange(gj.n_pad) < gj.n, 1.0 / gj.n, 0.0)
    aff = np.arange(gj.n_pad) < gj.n
    _assert_same(*_both(gj, gt, r0, aff, expand=False, tau=1e-10))


@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_fault_plan_with_delays(mode):
    plan = dict(n_threads=8, delay_prob=0.3, delay_ms=0.5, seed=4)
    gj, gt, r0, aff = _problem("grid", seed=2)
    _assert_same(*_both(gj, gt, r0, aff, jflt.FaultPlan(**plan),
                        tflt.FaultPlan(**plan), mode=mode, tau=1e-10))


@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_fault_plan_with_a_crash(mode):
    """LF survives a crashed pseudo-thread (its slots are picked up); BB
    stalls at the barrier and reports dnf — the same on both sides."""
    plan = dict(n_threads=8, n_crashed=2, crash_window=3, seed=6)
    gj, gt, r0, aff = _problem("rmat", seed=5)
    Rj, sj, Rt, st = _both(gj, gt, r0, aff, jflt.FaultPlan(**plan),
                           tflt.FaultPlan(**plan), mode=mode, tau=1e-10)
    _assert_same(Rj, sj, Rt, st)
    assert st.dnf == (mode == "bb")


def test_sweep_cap_and_host_syncs():
    """A capped drive stops at ``max_iterations`` exactly like the
    reference, and the port polls once per ``SWEEPS_PER_POLL`` sweeps."""
    gj, gt, r0, aff = _problem("grid", seed=9)
    _assert_same(*_both(gj, gt, r0, aff, max_iterations=11, tau=1e-14))
    inc = IncrementalPullMatrix.from_snapshot(gt, dtype=torch.float64)
    f = torch.tensor
    tables = [torch.as_tensor(a) for a in tflt.NO_FAULTS.device_tables(11)]
    _, sv, syncs = tpe._driver(
        inc.mat, torch.from_numpy(r0), torch.from_numpy(aff),
        gt.vertex_valid, gt.out_deg, torch.as_tensor(inc.aux.rb_in),
        torch.as_tensor(inc.aux.rb_out), torch.as_tensor(inc.aux.bmat),
        f(0.85, dtype=torch.float64), f(1e-14, dtype=torch.float64),
        f(1e-17, dtype=torch.float64), *tables, n=gt.n, block_size=32,
        mode="lf", expand=True, active_policy="affected", max_iterations=11)
    assert sv[0] == 11 and sv[5] == 0
    assert syncs == -(-11 // tpe.SWEEPS_PER_POLL)
