"""The blocked engine's host-paged edges (``tiering.EdgePager`` with
``run_blocked(pager=)``) against the port's unpaged run and the JAX
package's pager.

Twins of ``tests/test_tiering.py::test_edge_pager_parity_exact``,
``test_edge_pager_repack_and_slab_content`` and
``test_edge_pager_budget_floor_raises``, plus parity with JAX: a paged run
is ARRAY-EQUAL to the unpaged run of the port (the pager moves slices, the
sweep sums each slice in the same order), within 1e-12 of JAX's paged run
(the blocked engine's tolerance, ``tests/test_torch_blocked.py``), and the
pager counters equal JAX's after the same ``ensure`` calls.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import blocked as jblk
from repro.core import tiering as jtier
from repro.graphs.generators import rmat
from repro_torch.core import blocked as tblk
from repro_torch.core import tiering
from repro_torch.core.graph import HostGraph as THostGraph

CPU = "cpu"
TAU = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(scale, seed, block=64):
    hg = rmat(scale, 4, seed=seed)
    return (hg.snapshot(block_size=block),
            THostGraph(hg.n, hg.edges).snapshot(block_size=block,
                                                device=CPU))


@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_edge_pager_parity_exact(mode):
    """The paged run equals the unpaged run bit for bit and JAX's paged run
    within 1e-12, with the same counters and the same pager counters."""
    jg, tg = _pair(8, 3)
    R0 = np.full(tg.n_pad, 1.0 / tg.n)
    kw = dict(mode=mode, tau=TAU, active_policy="rc")
    base, st0 = tblk.run_blocked(tg, torch.from_numpy(R0), tg.vertex_valid,
                                 **kw)
    pager = tiering.EdgePager(tg, budget_bytes=1 << 26)
    paged, st1 = tblk.run_blocked(tiering.paged_snapshot(tg),
                                  torch.from_numpy(R0), tg.vertex_valid,
                                  pager=pager, **kw)
    assert torch.equal(base, paged)
    assert st1 == st0 and st1.converged
    assert pager.counters["misses"] > 0
    jpager = jtier.EdgePager(jg, budget_bytes=1 << 26)
    jR, js = jblk.run_blocked(jtier.paged_snapshot(jg), jnp.asarray(R0),
                              jg.vertex_valid, pager=jpager, **kw)
    assert (js.sweeps, js.blocks_processed, js.edges_processed) == (
        st1.sweeps, st1.blocks_processed, st1.edges_processed)
    assert np.abs(paged.numpy() - np.asarray(jR)).max() <= 1e-12
    assert pager.stats() == jpager.stats()


def test_edge_pager_repack_and_slab_content():
    """The repack path, driven directly on both pagers: a slab sized for
    half the blocks cycles between two disjoint working sets.  The staged
    slices equal the CSR slices (host slab and device view alike) and the
    counters equal JAX's after every ``ensure``."""
    jg, tg = _pair(8, 3)
    in_ptr = tg.in_block_ptr.numpy().astype(np.int64)
    out_ptr = tg.out_block_ptr.numpy().astype(np.int64)
    sizes = np.maximum(np.diff(in_ptr), np.diff(out_ptr))  # staging need
    floor = int((np.diff(in_ptr) + np.diff(out_ptr)).max())  # ctor floor
    n_blk = len(sizes)
    half = np.arange(n_blk // 2)
    rest = np.arange(n_blk // 2, n_blk)
    budget = (int(max(sizes[half].sum(), sizes[rest].sum(),
                      floor + 1)) + 8) * 16
    pager = tiering.EdgePager(tg, budget_bytes=budget)
    jpager = jtier.EdgePager(jg, budget_bytes=budget)
    src, dst = tg.src.numpy(), tg.dst.numpy()
    osrc, odst = tg.osrc.numpy(), tg.odst.numpy()

    def check(ids):
        view = pager.ensure(ids)
        jpager.ensure(ids)
        assert pager.counters == jpager.counters
        dsrc, ddst, dosrc, dodst, ilo, ilen, olo, olen = (
            t.numpy() for t in view)
        for b in ids.tolist():
            lo, ln = int(ilo[b]), int(ilen[b])
            assert ln == in_ptr[b + 1] - in_ptr[b]
            np.testing.assert_array_equal(
                pager._hsrc[lo:lo + ln], src[in_ptr[b]:in_ptr[b + 1]])
            np.testing.assert_array_equal(
                dsrc[lo:lo + ln], src[in_ptr[b]:in_ptr[b + 1]])
            np.testing.assert_array_equal(
                ddst[lo:lo + ln], dst[in_ptr[b]:in_ptr[b + 1]])
            lo, ln = int(olo[b]), int(olen[b])
            np.testing.assert_array_equal(
                dosrc[lo:lo + ln], osrc[out_ptr[b]:out_ptr[b + 1]])
            np.testing.assert_array_equal(
                dodst[lo:lo + ln], odst[out_ptr[b]:out_ptr[b + 1]])

    check(half)
    check(half)                 # all resident: pure hits
    assert pager.counters["hits"] > 0
    check(rest)                 # evicts the first set (repack)
    check(half)                 # and back
    assert pager.counters["repacks"] >= 1
    assert pager.counters["evictions"] >= 1
    # a want set that cannot fit even alone raises with the sizing rule
    with pytest.raises(ValueError, match="does not fit the edge slab"):
        pager.ensure(np.arange(n_blk))
    with pytest.raises(ValueError, match="does not fit the edge slab"):
        jpager.ensure(np.arange(n_blk))


def test_edge_pager_budget_floor_raises():
    jg, tg = _pair(7, 1)
    with pytest.raises(ValueError, match="raise the budget"):
        tiering.EdgePager(tg, budget_bytes=16)
    with pytest.raises(ValueError, match="raise the budget"):
        jtier.EdgePager(jg, budget_bytes=16)


def test_paged_snapshot_keeps_pointer_tables():
    """The stubbed snapshot holds one-element edge arrays and the original's
    per-block and per-vertex pointer tables, which a paged sweep rebases."""
    _, tg = _pair(7, 1)
    pg = tiering.paged_snapshot(tg)
    for name in ("src", "dst", "osrc", "odst"):
        assert getattr(pg, name).numel() == 1
    assert torch.equal(pg.in_ptr, tg.in_ptr)
    assert torch.equal(pg.in_block_ptr, tg.in_block_ptr)
    assert torch.equal(pg.out_block_ptr, tg.out_block_ptr)
    assert torch.equal(pg.out_deg, tg.out_deg)
