"""The port's blocked Gauss–Seidel engine against the JAX package's.

The same inputs (numpy, from a seed) go through ``repro.core.blocked`` (JAX
on the CPU) and ``repro_torch.core.blocked`` (``device="cpu"``, the sweep's
plain version).  One sweep: ``affected``, ``RC`` (their trash entry
included) and the per-slot edges ARRAY-EQUAL, ranks and ``maxdr`` within
1e-12 (same arithmetic, summation orders that differ by ~1e-18).  A driver
run: every ``SweepStats`` counter EQUAL, ``sim_time_ms`` within 1e-9
relative, ranks within 1e-12.  Twins of the blocked-engine cases of
``tests/test_blocked_cache.py``, ``tests/test_core_pagerank.py``,
``tests/test_pallas_engine.py``, ``tests/test_api_session.py`` and
``tests/test_fault_domains.py::TestConfigAxis`` run on the port's engines,
with ``engine=`` passed explicitly (the reference's default off the TPU is
``blocked``, the port's ``pallas``).
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.api import ThreadFaultDomain as JThreadFaultDomain
from repro.core import blocked as jblk
from repro.core import delta as jdelta
from repro.core import faults as jflt
from repro.core import frontier as jfr
from repro.core import pagerank as jpr
from repro.graphs import generators as jgen
from repro_torch.api import registry
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.core import blocked as tblk
from repro_torch.core import frontier as tfr
from repro_torch.core import pagerank as tpr
from repro_torch.core import tiering
from repro_torch.core.fault_domain import (FaultDomain, ThreadFaultDomain,
                                           resolve_thread_plan)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.kernels import nvcc
from repro_torch.kernels.blocked_sweep import blocked_sweep as bws

TAU = 1e-10
BAND = 1e-8          # tests/test_core_pagerank.py: error within 1e-9 at τ
STATS = ("sweeps", "iterations", "blocks_processed", "edges_processed",
         "converged", "dnf")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jhg, block):
    thg = THostGraph(jhg.n, jhg.edges)
    return (jhg.snapshot(block_size=block),
            thg.snapshot(block_size=block, device="cpu"))


def _same_stats(js, ts):
    for c in STATS:
        assert getattr(ts, c) == getattr(js, c), c
    assert ts.sim_time_ms == pytest.approx(js.sim_time_ms, rel=1e-9)


def _close(a, b, tol=1e-12):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= tol


# ---------------------------------------------------------------------------
# one sweep
# ---------------------------------------------------------------------------

GRAPHS = {
    "rmat10": lambda: jgen.rmat(10, avg_degree=6, seed=2),
    "kmer": lambda: jgen.kmer_chains(1 << 10, seed=4),
    # n = 500 on a 512-vertex grid: padding vertices in the last block
    "er500": lambda: jgen.erdos_renyi(500, avg_degree=6, seed=1),
}


def _sweep_inputs(jg, seed):
    """Ranks near the fixed point with per-block perturbations whose sizes
    run from 0 to 1e-8 (so some blocks change by less than τ_f, some by
    more than τ_f but less than τ, some by more than τ), a random affected
    set, and a slot list with −1 padding and masked slots."""
    rng = np.random.default_rng(seed)
    n_pad, B, nb = jg.n_pad, jg.block_size, jg.n_blocks
    ref = jpr.numpy_reference(jg, iterations=300)
    scale = np.repeat(10.0 ** rng.uniform(-15, -8, nb), B)
    scale[np.repeat(rng.random(nb) < 0.25, B)] = 0.0
    R = ref + scale * rng.standard_normal(n_pad)
    aff = np.r_[rng.random(n_pad) < 0.5, False]
    ids = np.full(nb + 5, -1, np.int32)
    order = rng.permutation(nb)[:nb - 1]
    ids[:len(order)] = order
    mask = rng.random(len(ids)) < 0.8
    return R, aff, ids, mask


def _ref_sweep(jg, R, aff, ids, mask, *, tile, expand, jacobi):
    tau_f = TAU / 1000.0 if expand else float("inf")
    Rj = jnp.asarray(R)
    out = jblk.sweep(jg, Rj, jnp.asarray(aff), jnp.asarray(aff),
                     jnp.asarray(ids), jnp.asarray(mask), Rj,
                     jnp.asarray(0.85), jnp.asarray(TAU), jnp.asarray(tau_f),
                     tile=tile, expand=expand, jacobi=jacobi,
                     dtype_name="float64")
    return [np.asarray(x) for x in out]


def _port_sweep(tg, R, aff, ids, mask, *, tile, expand, jacobi):
    tau_f = TAU / 1000.0 if expand else float("inf")
    Rt = torch.from_numpy(R.copy())
    a = torch.from_numpy(aff.copy())
    read = Rt.clone() if jacobi else Rt
    out = tblk.sweep(tg, Rt, a, a.clone(), torch.from_numpy(ids),
                     torch.from_numpy(mask), read, 0.85, TAU, tau_f,
                     tile=tile, expand=expand, jacobi=jacobi)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("tile", [64, 512])
@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sweep_matches_reference(graph, mode, expand, tile):
    jg, tg = _pair(GRAPHS[graph](), 64)
    R, aff, ids, mask = _sweep_inputs(jg, seed=len(graph) + tile)
    kw = dict(tile=tile, expand=expand, jacobi=mode == "bb")
    jR, jA, jC, jm, je = _ref_sweep(jg, R, aff, ids, mask, **kw)
    tR, tA, tC, tm, te = _port_sweep(tg, R, aff, ids, mask, **kw)
    np.testing.assert_array_equal(tA, jA)
    np.testing.assert_array_equal(tC, jC)
    np.testing.assert_array_equal(te, je)
    assert te.dtype == np.int32
    _close(tR, jR)
    _close(tm, jm)
    # masked and −1 slots count nothing; the others count their in-edges
    assert (te[~mask | (ids < 0)] == 0).all()
    assert (te[mask & (ids >= 0)] > 0).all()


def test_sweep_traps_are_exercised():
    """The inputs of test_sweep_matches_reference reach the cases the kernel
    must order or gate: a vertex whose change lies in (τ_f, τ] (its own RC
    write is False, then its self-loop's expansion sets it True — the RC
    race), a listed slot whose block changes by no more than τ_f (the
    expansion gate: no out-edges counted), and the trash entry set by the
    expansion's unflagged lanes."""
    jg, tg = _pair(GRAPHS["rmat10"](), 64)
    R, aff, ids, mask = _sweep_inputs(jg, seed=len("rmat10") + 64)
    tR, tA, tC, _, te = _port_sweep(tg, R, aff, ids, mask, tile=64,
                                    expand=True, jacobi=False)
    dr = np.abs(tR - R)
    upd = aff[:jg.n_pad] & np.asarray(jg.vertex_valid)
    mid = upd & (dr > TAU / 1000.0) & (dr <= TAU)
    assert mid.any() and tC[:jg.n_pad][mid].all()
    ibp = np.asarray(jg.in_block_ptr)
    live = mask & (ids >= 0)
    in_only = te[live] == (ibp[ids[live] + 1] - ibp[ids[live]])
    assert in_only.any() and (~in_only).any()
    assert tA[jg.n_pad] and tC[jg.n_pad]


def test_bb_sweep_refuses_to_read_the_ranks_it_writes():
    """In BB mode the reference reads the frozen sweep-start ranks; the
    port writes R in place, so a BB sweep given R itself as R_read raises
    instead of silently running Gauss–Seidel."""
    _, tg = _pair(GRAPHS["kmer"](), 64)
    R = tpr.initial_ranks(tg)
    aff = torch.cat([tg.vertex_valid, torch.zeros(1, dtype=torch.bool)])
    ids = torch.arange(tg.n_blocks, dtype=torch.int32)
    mask = torch.ones(tg.n_blocks, dtype=torch.bool)
    with pytest.raises(ValueError, match="copy of R"):
        tblk.sweep(tg, R, aff, aff.clone(), ids, mask, R, 0.85, TAU,
                   float("inf"), tile=512, expand=False, jacobi=True)
    with pytest.raises(ValueError, match="copy of R"):
        bws.blocked_sweep_plain(tblk.sweep_graph(tg, R.dtype), R, R, aff,
                                aff.clone(), ids, mask, n=tg.n, alpha=0.85,
                                tau=TAU, tau_f=1.0, tile=512, expand=False,
                                jacobi=True)


def test_sweep_routes_by_device():
    """A CPU tensor runs the plain version (no kernel launch, no build); the
    CUDA wrapper refuses a CPU tensor and a dtype it has no kernel for."""
    _, tg = _pair(GRAPHS["kmer"](), 64)
    R = tpr.initial_ranks(tg)
    aff = torch.cat([tg.vertex_valid, torch.zeros(1, dtype=torch.bool)])
    ids = torch.arange(tg.n_blocks, dtype=torch.int32)
    mask = torch.ones(tg.n_blocks, dtype=torch.bool)
    kw = dict(n=tg.n, alpha=0.85, tau=TAU, tau_f=float("inf"), tile=512,
              expand=False, jacobi=False)
    launches, builds = bws.blocked_sweep_cuda.launches, nvcc.total_builds()
    sg = tblk.sweep_graph(tg, R.dtype)
    bws.blocked_sweep(sg, R, R, aff, aff.clone(), ids, mask, **kw)
    assert bws.blocked_sweep_cuda.launches == launches
    assert nvcc.total_builds() == builds
    with pytest.raises(ValueError, match="CUDA"):
        bws.blocked_sweep_cuda(sg, R, R, aff, aff.clone(), ids, mask, **kw)
    Rh = R.to(torch.float16)
    sgh = tblk.sweep_graph(tg, torch.float16)
    with pytest.raises(ValueError, match="unsupported"):
        bws.blocked_sweep_cuda(sgh, Rh, Rh, aff, aff.clone(), ids, mask,
                               **kw)


# ---------------------------------------------------------------------------
# the driver loop
# ---------------------------------------------------------------------------

FAULTS = {
    "none": None,
    "crash": dict(n_threads=8, n_crashed=6, crash_window=4, seed=3),
    "delay": dict(n_threads=8, delay_prob=0.4, delay_ms=100, seed=5),
}


@pytest.fixture(scope="module")
def fault_setup():
    """tests/test_core_pagerank.py::TestFaultTolerance's inputs: rmat(10),
    B = 64, one batch of 1e-3 of the edges."""
    jhg0 = jgen.rmat(10, avg_degree=8, seed=7)
    dels, ins = jdelta.random_batch(jhg0, 1e-3, seed=1)
    jhg1 = jhg0.apply_batch(dels, ins)
    jg0, tg0 = _pair(jhg0, 64)
    jg1, tg1 = _pair(jhg1, 64)
    r_prev = jpr.numpy_reference(jg0, iterations=300)
    return dict(jg0=jg0, jg1=jg1, tg0=tg0, tg1=tg1, r_prev=r_prev,
                jb=jfr.batch_to_device(jg1, dels, ins),
                tb=tfr.batch_to_device(tg1, dels, ins),
                ref1=jpr.numpy_reference(jg1, iterations=300))


@pytest.mark.parametrize("faults", sorted(FAULTS))
@pytest.mark.parametrize("policy", ["affected", "rc"])
@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_run_blocked_matches_reference(fault_setup, mode, policy, faults):
    d = fault_setup
    kw = FAULTS[faults]
    j_aff = jfr.initial_affected(d["jg0"], d["jg1"], d["jb"])
    t_aff = tfr.initial_affected(d["tg0"], d["tg1"], d["tb"])
    np.testing.assert_array_equal(t_aff.numpy(), np.asarray(j_aff))
    jR, js = jblk.run_blocked(
        d["jg1"], jnp.asarray(d["r_prev"]), j_aff, mode=mode,
        active_policy=policy, tau=TAU,
        faults=jflt.FaultPlan(**kw) if kw else None)
    tR, ts = tblk.run_blocked(
        d["tg1"], torch.from_numpy(d["r_prev"]), t_aff, mode=mode,
        active_policy=policy, tau=TAU, faults=FaultPlan(**kw) if kw else None)
    _same_stats(js, ts)
    _close(tR, jR)
    assert ts.sweeps > 0
    assert ts.dnf == (mode == "bb" and faults == "crash")


def test_run_blocked_static_and_tile_match_reference(fault_setup):
    """A cold static LF run (no expansion) at tile 64, which splits vertices
    across the tiles of a block's edge range."""
    jg, tg = fault_setup["jg1"], fault_setup["tg1"]
    jR, js = jblk.run_blocked(jg, jnp.full(jg.n_pad, 1.0 / jg.n),
                              jg.vertex_valid, expand=False, tau=TAU, tile=64)
    tR, ts = tblk.run_blocked(tg, tpr.initial_ranks(tg), tg.vertex_valid,
                              expand=False, tau=TAU, tile=64)
    _same_stats(js, ts)
    _close(tR, jR)
    assert ts.converged


def test_run_blocked_rejects_a_pager_and_bad_modes(fault_setup):
    """A real pager runs, as the reference's does (its paged run equal to
    the unpaged one; tests/test_torch_pager.py has the twins); bad modes
    and policies raise."""
    tg = fault_setup["tg1"]
    R0 = tpr.initial_ranks(tg)
    base, st0 = tblk.run_blocked(tg, R0, tg.vertex_valid, expand=False,
                                 tau=TAU)
    pager = tiering.EdgePager(tg, budget_bytes=1 << 24)
    paged, st1 = tblk.run_blocked(tiering.paged_snapshot(tg), R0,
                                  tg.vertex_valid, expand=False, tau=TAU,
                                  pager=pager)
    assert torch.equal(base, paged) and st1 == st0
    assert pager.counters["misses"] > 0
    with pytest.raises(ValueError):
        tblk.run_blocked(tg, R0, tg.vertex_valid, mode="xx")
    with pytest.raises(ValueError):
        tblk.run_blocked(tg, R0, tg.vertex_valid, active_policy="xx")


# ---------------------------------------------------------------------------
# twins of tests/test_blocked_cache.py
# ---------------------------------------------------------------------------

def test_slot_capacity_ladder():
    assert tblk.slot_buckets(100) == (16, 64, 100)
    assert tblk.slot_buckets(8) == (8,)
    assert tblk.slot_buckets(16) == (16,)
    assert tblk.slot_capacity(1, 100) == 16
    assert tblk.slot_capacity(17, 100) == 64
    assert tblk.slot_capacity(65, 100) == 100     # clamped to n_blocks
    assert tblk.slot_capacity(100, 100) == 100
    # capacity shrinks when the frontier shrinks
    assert tblk.slot_capacity(70, 100) > tblk.slot_capacity(10, 100)
    # every reachable capacity is on the ladder
    for n_act in range(1, 101):
        assert tblk.slot_capacity(n_act, 100) in tblk.slot_buckets(100)
    for n_blocks in (1, 7, 16, 17, 100, 16384):
        assert tblk.slot_buckets(n_blocks) == jblk.slot_buckets(n_blocks)


def test_every_k_lies_on_the_ladder(monkeypatch):
    """Every slot count K a run sweeps is a ladder value, and a static run
    whose RC frontier decays from all blocks to none uses more than one of
    them (the port's counterpart of "a full static run compiles at most one
    sweep per ladder bucket")."""
    jhg = jgen.rmat(10, avg_degree=4, seed=5)
    g = THostGraph(jhg.n, jhg.edges).snapshot(block_size=16, device="cpu")
    ladder = tblk.slot_buckets(g.n_blocks)                # 64 blocks
    assert ladder == (16, 64)
    seen = []
    real = bws.blocked_sweep

    def record(sg, R, read, affected, rc, slot_ids, slot_mask, **kw):
        seen.append(int(slot_ids.shape[0]))
        return real(sg, R, read, affected, rc, slot_ids, slot_mask, **kw)

    monkeypatch.setattr(bws, "blocked_sweep", record)
    R, stats = tblk.run_blocked(g, tpr.initial_ranks(g), g.vertex_valid,
                                expand=False, tau=TAU, active_policy="rc")
    assert stats.converged and len(seen) == stats.sweeps
    assert set(seen) <= set(ladder) and len(set(seen)) > 1


def test_tau_alpha_sweep_builds_no_new_kernel(fault_setup):
    """α/τ/τ_f are kernel arguments: a hyperparameter sweep builds nothing
    (on the CPU nothing at all; tests/test_torch_cuda.py checks the card's
    one build)."""
    d = fault_setup
    builds = nvcc.total_builds()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for tau in (1e-9, 1e-10, 3e-10):
            for alpha in (0.85, 0.9):
                res = tpr.df_pagerank(d["tg0"], d["tg1"], d["tb"],
                                      d["r_prev"], mode="lf",
                                      engine="blocked", tau=tau, alpha=alpha)
                assert res.converged
    assert nvcc.total_builds() == builds == bws.builds() == 0


# ---------------------------------------------------------------------------
# twins of tests/test_core_pagerank.py (blocked and dense-LF cases)
# ---------------------------------------------------------------------------

def _legacy(mod, g0, g1, b, r, variant, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if variant == "static":
            return mod.static_pagerank(g1, **kw)
        if variant == "nd":
            return mod.nd_pagerank(g1, r, **kw)
        if variant == "dt":
            return mod.dt_pagerank(g0, g1, b, r, **kw)
        return mod.df_pagerank(g0, g1, b, r, **kw)


@pytest.mark.parametrize("gen", ["rmat", "erdos_renyi"])
@pytest.mark.parametrize("mode,engine", [("bb", "blocked"), ("lf", "blocked"),
                                         ("lf", "dense")])
def test_static_matches_oracle(gen, mode, engine):
    fn = getattr(jgen, gen)
    jg, tg = _pair(fn(9 if gen == "rmat" else 512, avg_degree=6, seed=1), 64)
    ref = tpr.numpy_reference(tg, iterations=300)
    res = _legacy(tpr, None, tg, None, None, "static", mode=mode,
                  engine=engine, tau=TAU)
    assert res.converged
    assert tpr.linf(res.ranks, ref) < BAND
    jres = _legacy(jpr, None, jg, None, None, "static", mode=mode,
                   engine=engine, tau=TAU)
    _same_stats(jres.stats, res.stats)
    _close(res.ranks, jres.ranks)


def test_dense_lf_is_the_blocked_engine(fault_setup):
    d = fault_setup
    args = (d["tg0"], d["tg1"], d["tb"], d["r_prev"], "df")
    dense = _legacy(tpr, *args, mode="lf", engine="dense")
    blocked = _legacy(tpr, *args, mode="lf", engine="blocked")
    assert torch.equal(dense.ranks, blocked.ranks)
    assert dense.stats == blocked.stats


class TestFaultTolerance:
    """tests/test_core_pagerank.py::TestFaultTolerance on engine="blocked",
    each run also held to the reference's (counters equal, ranks ≤ 1e-12)."""

    def _both(self, d, mode, **plan):
        j = _legacy(jpr, d["jg0"], d["jg1"], d["jb"],
                    jnp.asarray(d["r_prev"]), "df", mode=mode,
                    engine="blocked",
                    faults=jflt.FaultPlan(**plan) if plan else None)
        t = _legacy(tpr, d["tg0"], d["tg1"], d["tb"], d["r_prev"], "df",
                    mode=mode, engine="blocked",
                    faults=FaultPlan(**plan) if plan else None)
        _same_stats(j.stats, t.stats)
        _close(t.ranks, j.ranks)
        return t

    def test_lf_survives_crashes(self, fault_setup):
        d = fault_setup
        res = self._both(d, "lf", n_threads=8, n_crashed=6, crash_window=4,
                         seed=3)
        assert res.converged
        assert tpr.linf(res.ranks[:d["tg1"].n], d["ref1"][:d["tg1"].n]) \
            < BAND

    def test_bb_stalls_on_crash(self, fault_setup):
        res = self._both(fault_setup, "bb", n_threads=8, n_crashed=1,
                         crash_window=1, seed=3)
        assert res.stats.dnf and not res.converged

    def test_lf_survives_delays(self, fault_setup):
        d = fault_setup
        res = self._both(d, "lf", n_threads=8, delay_prob=0.4, delay_ms=100,
                         seed=5)
        assert res.converged
        assert tpr.linf(res.ranks[:d["tg1"].n], d["ref1"][:d["tg1"].n]) \
            < BAND

    def test_crash_slowdown_is_graceful(self, fault_setup):
        """More crashes → more simulated time, but always completes."""
        times = []
        for k in [0, 4, 6]:
            res = self._both(fault_setup, "lf", n_threads=8, n_crashed=k,
                             crash_window=1, seed=9)
            assert res.converged
            times.append(res.stats.sim_time_ms)
        assert times[0] <= times[1] <= times[2] * 1.001


# ---------------------------------------------------------------------------
# twins of tests/test_pallas_engine.py: the port's pallas engine against its
# blocked engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dyn():
    """tests/test_pallas_engine.py's fixture: rmat(9), B = 64."""
    jhg0 = jgen.rmat(9, avg_degree=6, seed=3)
    dels, ins = jdelta.random_batch(jhg0, 5e-3, seed=11)
    thg0 = THostGraph(jhg0.n, jhg0.edges)
    tg0 = thg0.snapshot(block_size=64, device="cpu")
    tg1 = thg0.apply_batch(dels, ins).snapshot(block_size=64, device="cpu")
    return dict(tg0=tg0, tg1=tg1, tb=tfr.batch_to_device(tg1, dels, ins),
                r_prev=tpr.numpy_reference(tg0, iterations=300),
                ref1=tpr.numpy_reference(tg1, iterations=300))


@pytest.mark.parametrize("mode", ["bb", "lf"])
def test_df_dynamic_matches_oracles_f64(dyn, mode):
    args = (dyn["tg0"], dyn["tg1"], dyn["tb"], dyn["r_prev"], "df")
    res = _legacy(tpr, *args, mode=mode, engine="pallas")
    assert res.converged
    n = dyn["tg1"].n
    assert tpr.linf(res.ranks[:n], dyn["ref1"][:n]) < BAND
    # vs the blocked (Gauss–Seidel) engine on the same run
    blkres = _legacy(tpr, *args, mode=mode, engine="blocked")
    assert blkres.converged
    assert tpr.linf(res.ranks, blkres.ranks) < BAND


def test_work_accounting_matches_blocked(dyn):
    """In BB mode both engines run the same Jacobi recurrence, so the fused
    driver's counters equal the blocked engine's: same sweeps, same
    frontier-proportional edge and block counts."""
    args = (dyn["tg0"], dyn["tg1"], dyn["tb"], dyn["r_prev"], "df")
    res_p = _legacy(tpr, *args, mode="bb", engine="pallas")
    res_b = _legacy(tpr, *args, mode="bb", engine="blocked")
    assert res_p.stats.sweeps == res_b.stats.sweeps
    assert res_p.stats.edges_processed == res_b.stats.edges_processed
    assert res_p.stats.blocks_processed == res_b.stats.blocks_processed


def test_bb_blocked_sweep_reads_in_sweep_marks():
    """ROADMAP C 7.  In BB mode the reference's blocked scan reads
    ``affected`` from its carry, so a slot updates a vertex that an earlier
    slot of the same sweep marked; the fused pallas driver updates it one
    sweep later.  The two engines therefore count the same work only while
    that never changes a τ_f gate (it did once on grid_road(256)).  One BB
    sweep on 8 vertices in two blocks shows it: vertex 0's change marks
    vertex 4 in slot 0, and only the blocked sweep then updates vertex 4 and
    counts block 1's out-edges.  The port reproduces each reference engine
    exactly."""
    from repro.core import pallas_engine as jpe
    from repro.core.graph import HostGraph as JHostGraph
    from repro_torch.core import pallas_engine as tpe
    edges = np.array([[0, 4], [1, 0], [2, 1], [3, 2], [4, 5], [5, 6],
                      [6, 7], [7, 3]])
    jg = JHostGraph(8, edges).snapshot(block_size=4)
    tg = THostGraph(8, edges).snapshot(block_size=4, device="cpu")
    R0 = tpr.numpy_reference(tg, iterations=300)
    R0[0] += 1e-3
    aff = np.zeros(8, bool)
    aff[[0, 5]] = True
    kw = dict(mode="bb", expand=True, tau=TAU, max_iterations=1)
    runs = {
        ("j", "blocked"): jblk.run_blocked(jg, jnp.asarray(R0),
                                           jnp.asarray(aff), **kw),
        ("j", "pallas"): jpe.run_pallas(jg, jnp.asarray(R0),
                                        jnp.asarray(aff), backend="xla",
                                        **kw),
        ("t", "blocked"): tblk.run_blocked(tg, torch.from_numpy(R0),
                                           torch.from_numpy(aff), **kw),
        ("t", "pallas"): tpe.run_pallas(tg, torch.from_numpy(R0),
                                        torch.from_numpy(aff), **kw)}
    for eng in ("blocked", "pallas"):
        _same_stats(runs["j", eng][1], runs["t", eng][1])
        _close(runs["t", eng][0], runs["j", eng][0])
    moved = {eng: np.asarray(runs["t", eng][0])[:8] != R0
             for eng in ("blocked", "pallas")}
    assert moved["blocked"][4] and not moved["pallas"][4]
    assert (moved["blocked"] == np.isin(np.arange(8), [0, 4])).all()
    assert runs["t", "blocked"][1].edges_processed == 32     # 2 x (8 + 8)
    assert runs["t", "pallas"][1].edges_processed == 24      # + block 0 out


# ---------------------------------------------------------------------------
# twins of tests/test_api_session.py on engine="blocked"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sdyn():
    """tests/test_api_session.py's fixture: rmat(9), B = 64."""
    jhg0 = jgen.rmat(9, avg_degree=6, seed=5)
    dels, ins = jdelta.random_batch(jhg0, 5e-3, seed=21)
    thg0 = THostGraph(jhg0.n, jhg0.edges)
    tg0 = thg0.snapshot(block_size=64, device="cpu")
    tg1 = thg0.apply_batch(dels, ins).snapshot(block_size=64, device="cpu")
    return dict(jhg0=jhg0, thg0=thg0, tg0=tg0, tg1=tg1,
                tb=tfr.batch_to_device(tg1, dels, ins),
                r_prev=tpr.numpy_reference(tg0, iterations=300),
                dels=dels, ins=ins)


class TestDeprecationShims:
    """Each legacy variant function must emit DeprecationWarning, route
    through PageRankSession, and match the session call bit-for-bit."""

    ENGINE = "blocked"

    def _cfg(self, mode):
        return TConfig(mode=mode, engine=self.ENGINE, block_size=64)

    def test_static(self, sdyn):
        with pytest.warns(DeprecationWarning, match="static_pagerank"):
            res = tpr.static_pagerank(sdyn["tg0"], mode="bb",
                                      engine=self.ENGINE)
        sess = TSession.from_snapshot(sdyn["tg0"], config=self._cfg("bb"))
        out = sess.recompute("static")
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    def test_nd(self, sdyn):
        with pytest.warns(DeprecationWarning, match="nd_pagerank"):
            res = tpr.nd_pagerank(sdyn["tg0"], sdyn["r_prev"], mode="lf",
                                  engine=self.ENGINE)
        sess = TSession.from_snapshot(sdyn["tg0"], config=self._cfg("lf"),
                                      r0=sdyn["r_prev"])
        out = sess.recompute("nd")
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    @pytest.mark.parametrize("variant", ["dt", "df"])
    def test_dt_df(self, sdyn, variant):
        """``test_dt`` / ``test_df``: the legacy call equals the update of a
        session that ``from_graph`` opens in snapshot mode."""
        fn = tpr.dt_pagerank if variant == "dt" else tpr.df_pagerank
        with pytest.warns(DeprecationWarning, match=f"{variant}_pagerank"):
            res = fn(sdyn["tg0"], sdyn["tg1"], sdyn["tb"], sdyn["r_prev"],
                     mode="lf", engine=self.ENGINE)
        sess = TSession.from_graph(sdyn["thg0"], config=self._cfg("lf"),
                                   r0=sdyn["r_prev"], device="cpu")
        assert not sess._stream
        out = sess.update(sdyn["dels"], sdyn["ins"], variant=variant)
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    def test_df_recompute_replays_last_batch(self, sdyn):
        sess = TSession.from_graph(sdyn["thg0"], config=self._cfg("lf"),
                                   r0=sdyn["r_prev"], device="cpu")
        out = sess.update(sdyn["dels"], sdyn["ins"], variant="df")
        replay = sess.recompute("df")
        assert torch.equal(out.ranks, replay.ranks)

    def test_recompute_dt_df_require_a_batch(self, sdyn):
        sess = TSession.from_graph(sdyn["thg0"], config=self._cfg("lf"),
                                   r0=sdyn["r_prev"], device="cpu")
        with pytest.raises(ValueError, match="no batch"):
            sess.recompute("df")

    def test_snapshot_session_matches_reference(self, sdyn):
        """The reference's blocked session (snapshot mode from from_graph)
        and the port's: the cold solve, a df update and a dt update agree
        in every counter and within 1e-12."""
        js = JSession.from_graph(sdyn["jhg0"], config=JConfig(
            engine="blocked", block_size=64, tau=TAU))
        ts = TSession.from_graph(sdyn["thg0"], config=self._cfg("lf"),
                                 device="cpu")
        _close(ts.R, js.R)
        dels, ins = sdyn["dels"], sdyn["ins"]
        for variant in ("df", "dt"):
            a = js.update(dels, ins, variant=variant)
            b = ts.update(dels, ins, variant=variant)
            _same_stats(a.stats, b.stats)
            _close(ts.R, js.R)
            dels, ins = ins, dels


def test_non_pallas_engines_reject_tile_operands(sdyn):
    for engine in ("blocked", "dense"):
        with pytest.raises(ValueError, match="only consumed by "
                                             "engine='pallas'"):
            _legacy(tpr, None, sdyn["tg0"], None, sdyn["r_prev"], "nd",
                    engine=engine, pallas_mat=object())
    eng = registry.resolve("blocked")
    g = sdyn["tg0"]
    with pytest.raises(ValueError, match="only consumed by "
                                         "engine='distributed'"):
        eng.run(g, tpr.initial_ranks(g), g.vertex_valid, mode="lf",
                expand=False, alpha=0.85, tau=TAU, tau_f=None,
                max_iterations=5, faults=None, tile=512,
                active_policy="affected", shards=object())


def test_unknown_engine_error_lists_registered():
    with pytest.raises(ValueError, match="blocked.*dense.*pallas"):
        registry.resolve("not-an-engine")
    # the walk engine registers since A 13, the distributed engine since
    # A 14a
    assert registry.names() == ("blocked", "dense", "distributed", "pallas",
                                "walk")
    assert registry.default_engine() == "pallas"
    eng = registry.resolve("blocked")
    assert isinstance(eng, registry.Engine)
    assert registry.fault_domains_of(eng) == ("thread", "process")
    assert registry.supports_of(eng) == frozenset()


# ---------------------------------------------------------------------------
# twins of tests/test_fault_domains.py::TestConfigAxis (the thread domain)
# ---------------------------------------------------------------------------

class TestConfigAxis:
    def test_fault_domain_type_checked(self):
        with pytest.raises(ValueError, match="fault_domain"):
            TConfig(fault_domain=object())

    def test_faults_and_thread_domain_exclusive(self):
        plan = FaultPlan(n_threads=4)
        with pytest.raises(ValueError, match="mutually exclusive"):
            TConfig(faults=plan, fault_domain=ThreadFaultDomain(plan))

    def test_thread_domain_rejected_on_sharded_topology(self):
        with pytest.raises(ValueError, match="ShardFaultDomain"):
            TConfig(topology="sharded", n_shards=1,
                    fault_domain=ThreadFaultDomain(FaultPlan(n_threads=4)))

    def test_thread_domain_equals_legacy_faults(self):
        """fault_domain=ThreadFaultDomain(plan) is faults=plan under the
        domain interface — bit-identical sweep results, and the reference's
        counters."""
        jhg = jgen.kmer_chains(1 << 10, seed=4)
        thg = THostGraph(jhg.n, jhg.edges)
        kw = dict(n_threads=8, n_crashed=2, crash_window=4, seed=5)
        plan = FaultPlan(**kw)
        dels, ins = jdelta.random_batch(jhg, 5e-3, seed=7)
        a = TSession.from_graph(thg, config=TConfig(
            engine="blocked", block_size=64, faults=plan), device="cpu")
        b = TSession.from_graph(thg, config=TConfig(
            engine="blocked", block_size=64,
            fault_domain=ThreadFaultDomain(plan)), device="cpu")
        ra = a.update(dels, ins)
        rb = b.update(dels, ins)
        assert ra.stats.converged and rb.stats.converged
        np.testing.assert_array_equal(a.R.numpy(), b.R.numpy())
        js = JSession.from_graph(jhg, config=JConfig(
            engine="blocked", block_size=64,
            fault_domain=JThreadFaultDomain(jflt.FaultPlan(**kw))))
        _same_stats(js.update(dels, ins).stats, rb.stats)
        _close(b.R, js.R)

    def test_thread_domain_plan_resolution(self):
        plan = FaultPlan(n_threads=4)
        assert resolve_thread_plan(plan, None) is plan
        assert resolve_thread_plan(None, ThreadFaultDomain(plan)) is plan
        assert resolve_thread_plan(None, None) is None
        dom = ThreadFaultDomain(n_threads=3, n_crashed=1)
        assert dom.plan.n_threads == 3 and dom.name == "thread"
        with pytest.raises(ValueError, match="not both"):
            ThreadFaultDomain(plan, n_threads=2)
        cfg = TConfig(engine="blocked", fault_domain=ThreadFaultDomain(plan))
        assert cfg.resolved_engine == "blocked"

    def test_other_domains_are_a_later_slice(self):
        class ProcessLike(FaultDomain):
            name = "process"

        class ShardLike(FaultDomain):
            name = "shard"

        # since A 11 a domain the engine declares gets the reference's
        # outcome (it constructs); since A 14b a shard domain off the
        # sharded topology gets the reference's ValueError too
        for engine in ("blocked", "pallas"):
            cfg = TConfig(engine=engine, fault_domain=ProcessLike())
            assert cfg.fault_domain.name == "process"
        with pytest.raises(ValueError, match="does not host the 'shard'"):
            TConfig(engine="blocked", fault_domain=ShardLike())
