"""``StreamRunner``'s forwarding surface (ROADMAP C 10): twins of the runner
tests of ``tests/test_stream.py`` on the port (``device="cpu"``).

The runner forwards the session state it holds and the module re-exports
``StreamBatchResult``, ``_seed_affected`` and ``_apply_operand_delta``.
One difference is kept: the port patches the tile pool and its packed
index in place, so the seed twin clones the pre-batch matrix before the
step (the reference's ``mat_prev`` is immutable).
"""
import numpy as np
import pytest
import torch

from repro.core import frontier as jfr
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import rmat
from repro_torch.api import session as tsession
from repro_torch.core import frontier as tfr
from repro_torch.core import pallas_engine as tpe
from repro_torch.core import stream as tstream
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.stream import StreamRunner
from repro_torch.kernels.block_spmv import ops

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream_setup():
    hg = rmat(9, avg_degree=6, seed=3)
    g = hg.snapshot(block_size=64)
    r0 = jpr.numpy_reference(g, iterations=300)
    batches = []
    cur = hg
    for i in range(4):
        dels, ins = random_batch(cur, 5e-3, seed=100 + i)
        batches.append((dels, ins))
        cur = cur.apply_batch(dels, ins)
    return hg, r0, batches


def _thg(hg):
    return THostGraph(hg.n, hg.edges)


def test_stream_seed_matches_initial_affected(stream_setup):
    """The tile-matrix frontier seed equals the snapshot-based marking of
    paper Alg. 1 lines 4-6 (and the reference's on its snapshots)."""
    hg, r0, batches = stream_setup
    runner = StreamRunner(_thg(hg), block_size=64, r0=r0, device=CPU)
    cur = hg
    for dels, ins in batches[:2]:
        mat_prev = runner.inc.mat.clone()      # patched in place by step
        g_prev = _thg(cur).snapshot(block_size=64, device=CPU)
        jg_prev = cur.snapshot(block_size=64)
        runner.step(dels, ins)
        cur = cur.apply_batch(dels, ins)
        g_new = _thg(cur).snapshot(block_size=64, device=CPU)
        batch = tfr.batch_to_device(g_new, dels, ins)
        want = tfr.initial_affected(g_prev, g_new, batch)
        got = tstream._seed_affected(
            mat_prev, runner.inc.mat, torch.as_tensor(runner.inc.aux.bmat),
            batch, runner.valid, block_size=64)
        assert bool(torch.equal(got, want))
        jg_new = cur.snapshot(block_size=64)
        jwant = jfr.initial_affected(jg_prev, jg_new,
                                     jfr.batch_to_device(jg_new, dels, ins))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_stream_device_mirrors_track_ground_truth(stream_setup):
    """The operand mirrors (out_deg / rb_in / rb_out / bmat), patched per
    batch in O(batch), equal what a fresh snapshot of the final graph
    gives, and stay in step with the host twins."""
    hg, r0, batches = stream_setup
    runner = StreamRunner(_thg(hg), block_size=64, r0=r0, device=CPU)
    cur = hg
    for dels, ins in batches:
        runner.step(dels, ins)
        cur = cur.apply_batch(dels, ins)
    g_fin = _thg(cur).snapshot(block_size=64, device=CPU)
    np.testing.assert_array_equal(runner._out_deg.numpy(),
                                  g_fin.out_deg.numpy())
    np.testing.assert_array_equal(runner._rb_in.numpy(),
                                  g_fin.block_in_edges().numpy())
    np.testing.assert_array_equal(runner._rb_out.numpy(),
                                  g_fin.block_out_edges().numpy())
    fresh_bmat = ops.block_adjacency(tpe.build_pull_matrix(g_fin)).numpy()
    got = runner._bmat.numpy()
    assert bool(np.all(got >= fresh_bmat))
    np.testing.assert_array_equal(got, runner.inc.aux.bmat)
    np.testing.assert_array_equal(runner._rb_in.numpy(),
                                  runner.inc.aux.rb_in)
    np.testing.assert_array_equal(runner._rb_out.numpy(),
                                  runner.inc.aux.rb_out)


def test_stream_rejects_unknown_mode():
    hg = rmat(8, avg_degree=4, seed=0)
    with pytest.raises(ValueError):
        StreamRunner(_thg(hg), mode="nope", device=CPU)


def test_runner_forwards_session_state(stream_setup):
    hg, r0, batches = stream_setup
    runner = StreamRunner(_thg(hg), block_size=64, r0=r0, device=CPU,
                          mode="lf", active_policy="rc", max_iterations=321)
    runner.step(*batches[0])
    s = runner.session
    for name in ("hg", "R", "inc", "valid", "n", "n_pad", "block_size",
                 "n_rb", "_out_deg", "_rb_in", "_rb_out", "_bmat"):
        assert getattr(runner, name) is getattr(s, name), name
    assert (runner.mode, runner.active_policy, runner.max_iterations) == \
        ("lf", "rc", 321)
    # the reference's interpret/backend knobs are dropped (ROADMAP C 1)
    assert not hasattr(runner, "interpret")
    assert not hasattr(runner, "backend")
    for name in ("StreamBatchResult", "_seed_affected",
                 "_apply_operand_delta"):
        assert name in tstream.__all__
        assert getattr(tstream, name) is getattr(tsession, name)
