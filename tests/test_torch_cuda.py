"""The hand-written CUDA kernels (reading the packed nonzero index) against
their plain PyTorch versions (reading the dense tiles), the index refresh on
the card, a stream on the card against the same stream on the CPU (pull and
push drivers), the push path's residual scatter, host syncs and masking
of the kernel's undefined rows, and the variant matrix (dt, the replays,
snapshot mode, the dense engine) on the card against the CPU, the blocked
engine's Gauss–Seidel sweep kernel against its plain version (over the
snapshot's CSR and over an ``EdgePager``'s slab, the paged sweep bit-equal
to the unpaged one), tiered pull and push sessions (the kernels
reading the packed hot slab) against the CPU, the integrity check
finding and healing a flipped entry of the index the kernels read, and the
walk kernels (``walk_regen``, ``walk_touch``) against their plain versions
and a walk session on the card against the same session on the CPU (exact:
the walks are integer and the draws counter-based), and an 8-shard sharded
session on the card against the CPU (kernel #1's launches counted per
sweep, the ``recompute("df")`` replay bit-equal).

Runs on a machine with a CUDA card and ``nvcc`` (no JAX needed):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.  Tolerances as
``tests/test_kernels.py``: f32 2e-5, bf16 3e-2, f64 1e-12 (different
summation orders).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_spmv import block_spmv as bsk
from repro_torch.kernels.block_spmv import ops as tops

# f32 products stay IEEE on the card (no TF32), as in the JAX tests
torch.backends.cuda.matmul.allow_tf32 = False

TOLS = {torch.float32: 2e-5, torch.float64: 1e-12, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["sum", "or"])
@pytest.mark.parametrize("t_dt", [torch.float32, torch.float64,
                                  torch.bfloat16])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256])
def test_cuda_kernels_match_plain(cuda_device, block, t_dt, semiring):
    """Both kernels on a padded layout; the active kernel writes into a
    NaN-filled buffer and must leave every inactive row untouched."""
    n = 700
    rng = np.random.default_rng(block)
    rows, cols = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    tol = TOLS[t_dt]
    mat = tops.build_block_sparse(rows, cols, n, n, block=block, dtype=t_dt,
                                  padded=True, device=cuda_device)
    xh = torch.from_numpy(rng.random(n))
    if semiring == "or":
        xh = (xh < 0.15).double()
    x = tops._pad_x(mat, xh.to(t_dt).to(cuda_device))
    kw = dict(block=block, max_tiles=mat.max_tiles, semiring=semiring)
    args = (mat.tile_idx, mat.tile_cols, mat.tiles, x)
    kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
    torch.testing.assert_close(bsk.block_spmv_cuda(*kargs, **kw),
                               bsk.block_spmv_plain(*args, **kw),
                               rtol=tol, atol=tol)
    act = torch.arange(0, mat.n_rb, 2, dtype=torch.int32)
    ids = torch.full((mat.n_rb,), -1, dtype=torch.int32)
    ids[:len(act)] = act
    ids = ids.to(cuda_device)
    out = torch.full((mat.n_rb * block,), float("nan"), dtype=t_dt,
                     device=cuda_device)
    ya = bsk.block_spmv_active_cuda(ids, *kargs, out=out, **kw)
    yp = bsk.block_spmv_active_plain(ids, *args, **kw)
    live = torch.zeros(mat.n_rb, dtype=torch.bool)
    live[act.long()] = True
    live = live.repeat_interleave(block).to(cuda_device)
    torch.testing.assert_close(ya[live], yp[live], rtol=tol, atol=tol)
    assert bool(torch.isnan(ya[~live]).all())


def _nan_out(mat, dtype, device):
    return torch.full((mat.n_rb * mat.block,), float("nan"), dtype=dtype,
                      device=device)


def _rows_of(ids, n_rb, block, device):
    live = np.zeros(n_rb, bool)
    live[ids[ids >= 0]] = True
    return torch.from_numpy(np.repeat(live, block)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("t_dt", [torch.float64, torch.float32])
def test_cuda_kernels_after_a_compacting_delta_stream(cuda_device, t_dt):
    """After every batch of a stream whose index refreshes in place and
    compacts at least once, both kernels equal their plain versions."""
    n, B = 900, 32
    rng = np.random.default_rng(17)
    tol = TOLS[t_dt]
    mat = tops.build_block_sparse(rng.integers(0, n, 5000),
                                  rng.integers(0, n, 5000), n, n, block=B,
                                  dtype=t_dt, padded=True, device=cuda_device)
    compacted = refreshed = 0
    for size in (15, 15, 2500, 15, 2500):
        tail0, e_cap0 = mat.index.tail, mat.index.entry_capacity
        mat = tops.apply_delta(mat, rng.integers(0, n, size),
                               rng.integers(0, n, size),
                               np.where(rng.random(size) < 0.3, -1.0, 1.0))
        if mat.index.tail < tail0 or mat.index.entry_capacity != e_cap0:
            compacted += 1
        else:
            refreshed += 1
        x = tops._pad_x(mat, torch.from_numpy(rng.random(n)).to(t_dt)
                        .to(cuda_device))
        kw = dict(block=B, max_tiles=mat.max_tiles, semiring="sum")
        args = (mat.tile_idx, mat.tile_cols, mat.tiles, x)
        kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
        torch.testing.assert_close(bsk.block_spmv_cuda(*kargs, **kw),
                                   bsk.block_spmv_plain(*args, **kw),
                                   rtol=tol, atol=tol)
        ids_h = np.arange(mat.n_rb, dtype=np.int32)
        ids = torch.from_numpy(ids_h).to(cuda_device)
        torch.testing.assert_close(
            bsk.block_spmv_active_cuda(ids, *kargs, **kw),
            bsk.block_spmv_active_plain(ids, *args, **kw),
            rtol=tol, atol=tol)
    assert compacted >= 1 and refreshed >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["sum", "or"])
def test_cuda_launches_are_bit_identical(cuda_device, semiring):
    """Fixed summation order, no atomics: two launches on the same inputs
    give the same bits."""
    n, B = 2000, 64
    rng = np.random.default_rng(23)
    mat = tops.build_block_sparse(rng.integers(0, n, 30000),
                                  rng.integers(0, n, 30000), n, n, block=B,
                                  dtype=torch.float32, padded=True,
                                  device=cuda_device)
    x = tops._pad_x(mat, torch.from_numpy(rng.random(n)).float()
                    .to(cuda_device))
    kw = dict(block=B, max_tiles=mat.max_tiles, semiring=semiring)
    kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
    assert torch.equal(bsk.block_spmv_cuda(*kargs, **kw),
                       bsk.block_spmv_cuda(*kargs, **kw))
    ids = torch.arange(mat.n_rb, dtype=torch.int32, device=cuda_device)
    assert torch.equal(bsk.block_spmv_active_cuda(ids, *kargs, **kw),
                       bsk.block_spmv_active_cuda(ids, *kargs, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("count", [None, 4])
def test_cuda_active_list_holes_and_device_count(cuda_device, count):
    """A −1 in the middle of the list is skipped; a device count
    ``n_active`` ends the walk, and the rows of the list's later entries
    stay unwritten."""
    n, B = 800, 16
    rng = np.random.default_rng(29)
    mat = tops.build_block_sparse(rng.integers(0, n, 6000),
                                  rng.integers(0, n, 6000), n, n, block=B,
                                  dtype=torch.float64, padded=True,
                                  device=cuda_device)
    x = tops._pad_x(mat, torch.from_numpy(rng.random(n)).to(cuda_device))
    kw = dict(block=B, max_tiles=mat.max_tiles, semiring="sum")
    pick = rng.choice(mat.n_rb, 7, replace=False).astype(np.int32)
    ids_h = np.full(mat.n_rb, -1, np.int32)
    ids_h[:2], ids_h[3:8] = pick[:2], pick[2:]          # −1 at slot 2
    ids = torch.from_numpy(ids_h).to(cuda_device)
    n_act = (None if count is None else
             torch.tensor(count, dtype=torch.int64, device=cuda_device))
    ya = bsk.block_spmv_active_cuda(
        ids, mat.tile_idx, mat.tile_cols, mat.index, x, n_active=n_act,
        out=_nan_out(mat, torch.float64, cuda_device), **kw)
    yp = bsk.block_spmv_active_plain(ids, mat.tile_idx, mat.tile_cols,
                                     mat.tiles, x, **kw)
    seen = ids_h if count is None else ids_h[:count]
    rows = _rows_of(seen, mat.n_rb, B, cuda_device)
    torch.testing.assert_close(ya[rows], yp[rows], rtol=1e-12, atol=1e-12)
    assert bool(torch.isnan(ya[~rows]).all())


@pytest.mark.cuda
def test_cuda_index_refresh_makes_no_host_sync(cuda_device):
    """``apply_delta`` on the card — the scatter and the index refresh, on a
    batch that opens tiles and on one that does not — runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    n, B = 1000, 32
    rng = np.random.default_rng(31)
    mat = tops.build_block_sparse(rng.integers(0, n, 5000),
                                  rng.integers(0, n, 5000), n, n, block=B,
                                  dtype=torch.float64, padded=True,
                                  device=cuda_device)
    torch.cuda.synchronize()
    batches = [(rng.integers(0, n, 40), rng.integers(0, n, 40), np.ones(40)),
               (np.array([0]), np.array([0]), np.zeros(1))]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r, c, v in batches:
            mat = tops.apply_delta(mat, r, c, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fresh = tops.build_index(mat.tiles)
    x = tops._pad_x(mat, torch.from_numpy(rng.random(n)).to(cuda_device))
    kw = dict(block=B, max_tiles=mat.max_tiles, semiring="sum")
    torch.testing.assert_close(
        bsk.block_spmv_cuda(mat.tile_idx, mat.tile_cols, mat.index, x, **kw),
        bsk.block_spmv_cuda(mat.tile_idx, mat.tile_cols, fresh, x, **kw),
        rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_session_matches_cpu_session(cuda_device):
    """The same stream on the card and on the CPU: equal counters, ranks
    within 1e-12 (kernel vs plain summation order), and the card's run went
    through both kernels."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(64, seed=7)
    cfg = EngineConfig(block_size=64, tau=1e-10)
    launches0 = (bsk.block_spmv_cuda.launches,
                 bsk.block_spmv_active_cuda.launches)
    gpu = PageRankSession.from_graph(hg, config=cfg, device=cuda_device)
    cpu = PageRankSession.from_graph(hg, config=cfg, device="cpu")
    for i, variant in enumerate(["df", "df", "nd"]):
        dels, ins = random_batch(cpu.hg, 1e-3, seed=i, deletions_frac=0.2)
        a = gpu.update(dels, ins, variant=variant)
        b = cpu.update(dels, ins, variant=variant)
        for c in ("sweeps", "iterations", "blocks_processed",
                  "edges_processed", "converged"):
            assert getattr(a.stats, c) == getattr(b.stats, c), c
        assert float((gpu.R.cpu() - cpu.R).abs().max()) <= 1e-12
    assert bsk.block_spmv_cuda.launches > launches0[0]
    assert bsk.block_spmv_active_cuda.launches > launches0[1]


@pytest.mark.cuda
def test_cuda_variant_matrix_matches_cpu(cuda_device):
    """dt updates, the df/dt replays, ``df_pagerank`` with helping and the
    dense engine on the card against the same calls on the CPU: equal
    marks and counters, ranks within 1e-12."""
    import warnings
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core import frontier as fr
    from repro_torch.core import pagerank as pr
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(64, seed=7)
    cfg = EngineConfig(block_size=64, tau=1e-10)
    gpu = PageRankSession.from_graph(hg, config=cfg, device=cuda_device)
    cpu = PageRankSession.from_graph(hg, config=cfg, device="cpu")

    def same(a, b):
        for c in ("sweeps", "iterations", "blocks_processed",
                  "edges_processed", "converged"):
            assert getattr(a.stats, c) == getattr(b.stats, c), c
        assert float((a.ranks.cpu() - b.ranks).abs().max()) <= 1e-12

    for i in range(2):
        dels, ins = random_batch(cpu.hg, 1e-3, seed=10 + i,
                                 deletions_frac=0.2)
        same(gpu.update(dels, ins, variant="dt"),
             cpu.update(dels, ins, variant="dt"))
        assert gpu._dt_bfs == cpu._dt_bfs
    for variant in ("df", "dt"):
        same(gpu.recompute(variant), cpu.recompute(variant))
    dels, ins = random_batch(cpu.hg, 1e-3, seed=20, deletions_frac=0.2)
    out = []
    for dev in (cuda_device, "cpu"):
        g0 = cpu.hg.snapshot(block_size=64, device=dev)
        g1 = cpu.hg.apply_batch(dels, ins).snapshot(block_size=64,
                                                    device=dev)
        b = fr.batch_to_device(g1, dels, ins)
        first = np.arange(b.shape[0]) % 3 == 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            out.append((fr.dt_affected(g0, g1, b),
                        pr.df_pagerank(g0, g1, b, cpu.ranks, tau=1e-10,
                                       helping_first_pass=first),
                        pr.static_pagerank(g1, engine="dense", tau=1e-10)))
    (dt_g, df_g, dense_g), (dt_c, df_c, dense_c) = out
    assert torch.equal(dt_g.cpu(), dt_c)
    same(df_g, df_c)
    same(dense_g, dense_c)


@pytest.mark.cuda
def test_cuda_pull_all_and_or_scatter_repeat_bit_for_bit(cuda_device):
    """``pull_all``'s segmented sum and ``out_neighbor_or``'s max-scatter
    give the same bits on every call on the card; the sum agrees with the
    CPU's within the f64 tolerance (another summation order), the OR
    exactly."""
    from repro_torch.core.graph import out_neighbor_or, pull_all
    from repro_torch.graphs.generators import rmat
    hg = rmat(12, avg_degree=8, seed=4)
    gg = hg.snapshot(block_size=64, device=cuda_device)
    gc = hg.snapshot(block_size=64, device="cpu")
    rng = np.random.default_rng(1)
    r = torch.from_numpy(rng.random(gc.n_pad))
    f = torch.from_numpy(rng.random(gc.n_pad) < 0.05)
    y = pull_all(gg, r.to(cuda_device), alpha=0.85)
    assert torch.equal(y, pull_all(gg, r.to(cuda_device), alpha=0.85))
    torch.testing.assert_close(y.cpu(), pull_all(gc, r, alpha=0.85),
                               rtol=0, atol=TOLS[torch.float64])
    hit = out_neighbor_or(gg, f.to(cuda_device))
    assert torch.equal(hit.cpu(), out_neighbor_or(gc, f))


def _push_session(device):
    """A push session over ``grid_road(48)`` on ``device``."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.graphs.generators import grid_road
    return PageRankSession.from_graph(
        grid_road(48, seed=7),
        config=EngineConfig(block_size=64, tau=1e-10, driver="push"),
        device=device)


@pytest.mark.cuda
def test_cuda_push_session_matches_cpu_session(cuda_device):
    """The same push stream on the card and on the CPU: equal counters,
    ranks and residuals within 1e-12; the df sweeps launch kernel #2 and
    the nd update's residual rebuild kernel #1."""
    from repro_torch.core.delta import random_batch
    gpu, cpu = _push_session(cuda_device), _push_session("cpu")
    assert float((gpu.R.cpu() - cpu.R).abs().max()) <= 1e-12
    for i, variant in enumerate(["df", "df", "nd"]):
        dels, ins = random_batch(cpu.hg, 1e-3, seed=i, deletions_frac=0.2)
        launches0 = (bsk.block_spmv_cuda.launches,
                     bsk.block_spmv_active_cuda.launches)
        a = gpu.update(dels, ins, variant=variant)
        b = cpu.update(dels, ins, variant=variant)
        for c in ("sweeps", "blocks_processed", "edges_processed",
                  "converged"):
            assert getattr(a.stats, c) == getattr(b.stats, c), c
        assert a.pushed_blocks == b.pushed_blocks
        assert float((gpu.R.cpu() - cpu.R).abs().max()) <= 1e-12
        assert float((gpu._residual.cpu() - cpu._residual).abs().max()) \
            <= 1e-12
        assert bsk.block_spmv_active_cuda.launches > launches0[1]
        if variant == "nd":
            assert bsk.block_spmv_cuda.launches > launches0[0]


@pytest.mark.cuda
def test_cuda_scatter_residual_duplicates_bit_identical(cuda_device):
    from repro_torch.core import push_engine as pshe
    rng = np.random.default_rng(12)
    r = torch.from_numpy(rng.standard_normal(4096) * 1e-7).to(cuda_device)
    idx = rng.integers(0, 64, 20000)            # ~300 occurrences per index
    vals = rng.standard_normal(20000) * 1e-9
    a = pshe.scatter_residual(r, idx, vals)
    b = pshe.scatter_residual(r, idx, vals)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), pshe.scatter_residual(r.cpu(), idx, vals))


@pytest.mark.cuda
def test_cuda_push_drive_syncs_only_at_its_polls(cuda_device, monkeypatch):
    """A push drive and a residual scatter on the card run under
    ``torch.cuda.set_sync_debug_mode("error")``; only the driver's poll,
    once per chunk of sweeps, reads back."""
    from repro_torch.core import push_engine as pshe
    from repro_torch.core.delta import random_batch
    gpu = _push_session(cuda_device)
    dels, ins = random_batch(gpu.hg, 1e-3, seed=3, deletions_frac=0.2)
    gpu.update(dels, ins)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, gpu.n, 3000)
    vals = rng.standard_normal(3000) * 1e-6
    polls = []
    real = pshe._poll

    def poll(sv):
        torch.cuda.set_sync_debug_mode("default")
        try:
            polls.append(1)
            return real(sv)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(pshe, "_poll", poll)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu._residual = pshe.scatter_residual(gpu._residual, idx, vals)
        _, stats, _, syncs = gpu._drive_push(gpu.R)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stats.converged and stats.sweeps > 0
    assert syncs == len(polls) == stats.sweeps // 8 + 1


@pytest.mark.cuda
def test_cuda_push_rows_outside_candidates_never_reach_r(cuda_device,
                                                          monkeypatch):
    """A push drive whose active-kernel outputs all start as NaN equals the
    clean drive bit for bit, from the same (p, r) state."""
    from repro_torch.core import push_engine as pshe
    gpu = _push_session(cuda_device)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, gpu.n, 500)
    P0 = gpu.R.clone()
    R0 = pshe.scatter_residual(gpu._residual, idx, np.full(500, 1e-6))
    gpu._residual = R0.clone()
    clean_p, clean_stats, _, _ = gpu._drive_push(P0)
    clean_r = gpu._residual

    def poisoned(active_ids, tile_idx, tile_cols, tiles, x, *, index, **kw):
        out = torch.full((tile_cols.shape[0] * kw["block"],), float("nan"),
                         dtype=x.dtype, device=x.device)
        return bsk.block_spmv_active_cuda(active_ids, tile_idx, tile_cols,
                                          index, x, out=out, **kw)

    monkeypatch.setattr(bsk, "tile_spmv_active", poisoned)
    gpu._residual = R0.clone()
    dirty_p, dirty_stats, _, _ = gpu._drive_push(P0)
    assert clean_stats.sweeps > 0 and clean_stats == dirty_stats
    assert torch.equal(clean_p, dirty_p)
    assert torch.equal(clean_r, gpu._residual)


# ---------------------------------------------------------------------------
# the blocked engine's Gauss–Seidel sweep kernel
# ---------------------------------------------------------------------------

def _sweep_inputs(g, dtype, seed):
    """Ranks near the fixed point with per-block perturbations from 0 up to
    1e-8 (f64) or 1e-4 (f32) — some blocks change by less than τ_f, some by
    more than τ_f but less than τ (the RC race), some by more than τ — a
    random affected set, and a slot list with −1 padding and masked
    slots."""
    from repro_torch.core.pagerank import numpy_reference
    rng = np.random.default_rng(seed)
    n_pad, B, nb = g.n_pad, g.block_size, g.n_blocks
    lo, hi = (-15, -8) if dtype == torch.float64 else (-10, -4)
    scale = np.repeat(10.0 ** rng.uniform(lo, hi, nb), B)
    scale[np.repeat(rng.random(nb) < 0.25, B)] = 0.0
    R = numpy_reference(g, iterations=300) + scale * rng.standard_normal(n_pad)
    aff = np.r_[rng.random(n_pad) < 0.5, False]
    ids = np.full(nb + 5, -1, np.int32)
    order = rng.permutation(nb)[:max(1, nb - 1)]
    ids[:len(order)] = order
    mask = rng.random(len(ids)) < 0.8
    return (torch.from_numpy(R).to(dtype), torch.from_numpy(aff),
            torch.from_numpy(ids), torch.from_numpy(mask))


def _sweep_graphs():
    from repro_torch.core.graph import HostGraph
    from repro_torch.graphs.generators import kmer_chains, rmat
    rng = np.random.default_rng(0)
    er = HostGraph(500, rng.integers(0, 500, (3000, 2)))   # n < n_pad
    return rmat(10, avg_degree=6, seed=2), kmer_chains(1 << 10, seed=4), er


def _run_sweep(fn, sg, R, aff, ids, mask, g, *, jacobi, **kw):
    R, aff = R.clone(), aff.clone()
    rc = aff.clone()
    read = R.clone() if jacobi else R
    maxdr, edges = fn(sg, R, read, aff, rc, ids, mask, n=g.n, jacobi=jacobi,
                      **kw)
    return R, aff, rc, maxdr, edges


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("tile", [64, 512])
@pytest.mark.parametrize("t_dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("block", [64, 256])
def test_cuda_blocked_sweep_matches_plain(cuda_device, block, t_dt, tile,
                                          mode, expand):
    """The kernel on the card against the plain version on the CPU (whose
    sums run in the kernel's order): affected, RC (trash entry included)
    and the per-slot edges array-equal, R and maxdr within the dtype's
    tolerance; two launches bit-identical."""
    from repro_torch.core import blocked as blk
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    tau = 1e-10 if t_dt == torch.float64 else 1e-7
    kw = dict(alpha=0.85, tau=tau, tau_f=tau / 1000 if expand
              else float("inf"), tile=tile, expand=expand,
              jacobi=mode == "bb")
    for i, hg in enumerate(_sweep_graphs()):
        g = hg.snapshot(block_size=block, device="cpu")
        gc = hg.snapshot(block_size=block, device=cuda_device)
        R, aff, ids, mask = _sweep_inputs(g, t_dt, seed=block + tile + i)
        sg, sgc = blk.sweep_graph(g, t_dt), blk.sweep_graph(gc, t_dt)
        plain = _run_sweep(bws.blocked_sweep_plain, sg, R, aff, ids, mask, g,
                           **kw)
        dev = [t.to(cuda_device) for t in (R, aff, ids, mask)]
        launches = bws.blocked_sweep_cuda.launches
        runs = [_run_sweep(bws.blocked_sweep_cuda, sgc, *dev, gc, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert bws.blocked_sweep_cuda.launches == launches + 2
        for a, b in zip(runs[0], runs[1]):
            assert torch.equal(a, b)
        Rk, affk, rck, mk, ek = (t.cpu() for t in runs[0])
        Rp, affp, rcp, mp, ep = plain
        assert torch.equal(affk, affp) and torch.equal(rck, rcp)
        assert torch.equal(ek, ep)
        torch.testing.assert_close(Rk, Rp, rtol=0, atol=TOLS[t_dt])
        torch.testing.assert_close(mk, mp, rtol=0, atol=TOLS[t_dt])


def _hazard_graphs(n=4096):
    """Graphs for the pipelined sweep's hazard rule: a chain whose every
    block shares edges with the next and the last (each slot, in block
    order, reads the fresh ranks of the slot before it and marks the one
    after it), and a hub whose blocks' in- and out-edges (some 4,200 each,
    once duplicate edges merge) exceed the ring's chunk, so their slots
    stream through it in pieces."""
    from repro_torch.core.graph import HostGraph
    rng = np.random.default_rng(11)
    i = np.arange(n - 1)
    near = (rng.integers(0, n, n // 4)
            + rng.integers(-128, 129, n // 4)) % n
    chain = np.concatenate([np.stack([i, i + 1], 1), np.stack([i + 1, i], 1),
                            np.stack([rng.integers(0, n, n // 4), near], 1)])
    hub = np.concatenate([np.stack([rng.integers(0, n, 12000),
                                    np.full(12000, 100)], 1),
                          np.stack([np.full(12000, 2100),
                                    rng.integers(0, n, 12000)], 1),
                          rng.integers(0, n, (4 * n, 2))])
    return HostGraph(n, chain), HostGraph(n, hub)


def _in_order_inputs(g, dtype, seed, keep=()):
    """As :func:`_sweep_inputs`, with the slots in block order (holes and
    masked slots kept), so adjacent blocks follow each other; the blocks
    in ``keep`` are unmasked (and take a −1 slot if the list lacks them)."""
    R, aff, ids, mask = _sweep_inputs(g, dtype, seed)
    ids, mask = ids.numpy().copy(), mask.numpy().copy()
    live = ids >= 0
    ids[live] = np.sort(ids[live])
    for b in keep:
        if b not in ids:
            ids[np.nonzero(ids < 0)[0][0]] = b
        mask[ids == b] = True
    return R, aff, torch.from_numpy(ids), torch.from_numpy(mask)


def _check_hazard_sweep(cuda_device, hg, block, hubs, seed, t_dt, mode,
                        expand):
    """The kernel against the plain version on ``hg`` at block size
    ``block``, the slots in block order and the blocks in ``hubs`` among
    them: affected, RC and per-slot edges array-equal, R and maxdr within
    the dtype's tolerance, two launches bit-identical, and a paged sweep
    bit-identical to the unpaged one."""
    from repro_torch.core import blocked as blk
    from repro_torch.core import tiering
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    tau = 1e-10 if t_dt == torch.float64 else 1e-7
    kw = dict(alpha=0.85, tau=tau, tau_f=tau / 1000 if expand
              else float("inf"), tile=64, expand=expand,
              jacobi=mode == "bb")
    g = hg.snapshot(block_size=block, device="cpu")
    gc = hg.snapshot(block_size=block, device=cuda_device)
    R, aff, ids, mask = _in_order_inputs(g, t_dt, seed=seed, keep=hubs)
    plain = _run_sweep(bws.blocked_sweep_plain, blk.sweep_graph(g, t_dt), R,
                       aff, ids, mask, g, **kw)
    dev = [t.to(cuda_device) for t in (R, aff, ids, mask)]
    sgc = blk.sweep_graph(gc, t_dt)
    runs = [_run_sweep(bws.blocked_sweep_cuda, sgc, *dev, gc, **kw)
            for _ in range(2)]
    live = ids.numpy()[(ids.numpy() >= 0) & mask.numpy()]
    view = tiering.EdgePager(gc, budget_bytes=1 << 24).ensure(live)
    paged = _run_sweep(bws.blocked_sweep_cuda,
                       blk.sweep_graph(tiering.paged_snapshot(gc), t_dt,
                                       view), *dev, gc, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(runs[0], runs[1], paged):
        assert torch.equal(a, b) and torch.equal(a, c)
    Rk, affk, rck, mk, ek = (t.cpu() for t in runs[0])
    Rp, affp, rcp, mp, ep = plain
    assert torch.equal(affk, affp) and torch.equal(rck, rcp)
    assert torch.equal(ek, ep)
    torch.testing.assert_close(Rk, Rp, rtol=0, atol=TOLS[t_dt])
    torch.testing.assert_close(mk, mp, rtol=0, atol=TOLS[t_dt])
    assert set(hubs) <= set(live.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("t_dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("graph", ["chain", "hub"])
def test_cuda_blocked_sweep_hazard_graphs(cuda_device, graph, t_dt, mode,
                                          expand):
    """The pipelined kernel against the plain version where the hazard rule
    and the ring's chunks matter (B = 64): see :func:`_check_hazard_sweep`."""
    hg = dict(zip(("chain", "hub"), _hazard_graphs()))[graph]
    hubs = (100 // 64, 2100 // 64) if graph == "hub" else ()
    _check_hazard_sweep(cuda_device, hg, 64, hubs, len(graph), t_dt, mode,
                        expand)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("t_dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("block, graph, n", [
    (1, "chain", 65536), (16, "chain", 4096), (16, "hub", 4096),
    (1024, "chain", 4096), (1024, "hub", 4096)])
def test_cuda_blocked_sweep_hazard_block_sizes(cuda_device, block, graph, n,
                                               t_dt, mode):
    """The hazard checks of :func:`_check_hazard_sweep`, with expansion, at
    the block sizes whose launch differs from B = 64's: B <= 32 (one
    consumer warp, whose vote is a warp vote), B = 1024 (two vertices a
    consumer thread and the fewest producer warps), and B = 1 at
    n = 65,536 (a slot a vertex: 65,536 slots, more than shared memory
    could hold a slot table for)."""
    hg = dict(zip(("chain", "hub"), _hazard_graphs(n)))[graph]
    hubs = (100 // block, 2100 // block) if graph == "hub" else ()
    _check_hazard_sweep(cuda_device, hg, block, hubs, block + len(graph),
                        t_dt, mode, True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lf", "bb"])
def test_cuda_blocked_sweep_block_named_twice(cuda_device, mode):
    """A slot list that names blocks twice (the kernel then stages each
    slot only after the one before it is done): equal to the plain
    version, two launches bit-identical."""
    from repro_torch.core import blocked as blk
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    hg = _hazard_graphs()[0]
    kw = dict(alpha=0.85, tau=1e-10, tau_f=1e-13, tile=64, expand=True,
              jacobi=mode == "bb")
    g = hg.snapshot(block_size=64, device="cpu")
    gc = hg.snapshot(block_size=64, device=cuda_device)
    R, aff, ids, mask = _in_order_inputs(g, torch.float64, seed=5)
    ids = torch.cat([ids, ids[:40:3]])
    mask = torch.cat([mask, torch.ones(len(ids) - len(mask),
                                       dtype=torch.bool)])
    plain = _run_sweep(bws.blocked_sweep_plain,
                       blk.sweep_graph(g, torch.float64), R, aff, ids, mask,
                       g, **kw)
    dev = [t.to(cuda_device) for t in (R, aff, ids, mask)]
    sgc = blk.sweep_graph(gc, torch.float64)
    runs = [_run_sweep(bws.blocked_sweep_cuda, sgc, *dev, gc, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    Rk, affk, rck, mk, ek = (t.cpu() for t in runs[0])
    Rp, affp, rcp, mp, ep = plain
    assert torch.equal(affk, affp) and torch.equal(rck, rcp)
    assert torch.equal(ek, ep)
    torch.testing.assert_close(Rk, Rp, rtol=0, atol=TOLS[torch.float64])
    torch.testing.assert_close(mk, mp, rtol=0, atol=TOLS[torch.float64])


@pytest.mark.cuda
def test_cuda_blocked_sweep_refuses_bad_operands(cuda_device):
    """A BB sweep reading the R it writes, a dtype with no kernel, and an
    operand on another device all raise before any launch."""
    from repro_torch.core import blocked as blk
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    g = _sweep_graphs()[0].snapshot(block_size=64, device=cuda_device)
    R, aff, ids, mask = (t.to(cuda_device) for t in
                         _sweep_inputs(g, torch.float64, seed=1))
    sg = blk.sweep_graph(g, torch.float64)
    kw = dict(n=g.n, alpha=0.85, tau=1e-10, tau_f=1e-13, tile=512,
              expand=True)
    launches = bws.blocked_sweep_cuda.launches
    with pytest.raises(ValueError, match="copy of R"):
        bws.blocked_sweep_cuda(sg, R, R, aff, aff.clone(), ids, mask,
                               jacobi=True, **kw)
    Rh = R.to(torch.float16)
    with pytest.raises(ValueError, match="unsupported"):
        bws.blocked_sweep_cuda(blk.sweep_graph(g, torch.float16), Rh, Rh,
                               aff, aff.clone(), ids, mask, jacobi=False,
                               **kw)
    with pytest.raises(ValueError, match="device"):
        bws.blocked_sweep_cuda(sg, R, R, aff, aff.clone(), ids.cpu(), mask,
                               jacobi=False, **kw)
    assert bws.blocked_sweep_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode,faults", [
    ("lf", None), ("bb", None),
    ("lf", dict(n_threads=8, n_crashed=6, crash_window=4, seed=3)),
    ("lf", dict(n_threads=8, delay_prob=0.4, delay_ms=100, seed=5)),
    ("bb", dict(n_threads=8, n_crashed=1, crash_window=1, seed=3))])
@pytest.mark.parametrize("policy", ["affected", "rc"])
def test_cuda_run_blocked_matches_cpu(cuda_device, mode, faults, policy):
    """A DF run of the blocked engine on the card (the sweep kernel) and on
    the CPU (its plain version): every counter equal, ranks within 1e-12."""
    from repro_torch.core import blocked as blk
    from repro_torch.core import frontier as fr
    from repro_torch.core.delta import random_batch
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.pagerank import numpy_reference
    from repro_torch.graphs.generators import grid_road
    hg0 = grid_road(48, seed=7)
    dels, ins = random_batch(hg0, 1e-3, seed=2, deletions_frac=0.2)
    out = []
    for dev in ("cpu", cuda_device):
        g0 = hg0.snapshot(block_size=64, device=dev)
        g1 = hg0.apply_batch(dels, ins).snapshot(block_size=64, device=dev)
        aff = fr.initial_affected(g0, g1, fr.batch_to_device(g1, dels, ins))
        r_prev = torch.from_numpy(numpy_reference(g0, iterations=300))
        out.append(blk.run_blocked(
            g1, r_prev, aff, mode=mode, active_policy=policy, tau=1e-10,
            faults=FaultPlan(**faults) if faults else None))
    (rc_, sc), (rg, sg) = out
    assert sc == sg
    assert sg.sweeps > 0 or sg.dnf
    assert float((rg.cpu() - rc_).abs().max()) <= TOLS[torch.float64]


@pytest.mark.cuda
def test_cuda_tau_alpha_sweep_builds_no_new_kernel(cuda_device):
    """α/τ/τ_f are kernel arguments: after the first launch a
    hyperparameter sweep builds nothing (twin of
    tests/test_blocked_cache.py::test_tau_alpha_sweep_hits_one_cache_entry)."""
    import warnings
    from repro_torch.core import frontier as fr
    from repro_torch.core import pagerank as pr
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    hg = rmat(9, avg_degree=6, seed=2)
    g = hg.snapshot(block_size=64, device=cuda_device)
    r0 = pr.numpy_reference(g, iterations=200)
    dels, ins = random_batch(hg, 5e-3, seed=4)
    g1 = hg.apply_batch(dels, ins).snapshot(block_size=64,
                                            device=cuda_device)
    batch = fr.batch_to_device(g1, dels, ins)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pr.df_pagerank(g, g1, batch, r0, mode="lf", engine="blocked",
                       tau=1e-8)
        before = bws._Library.builds
        assert before == 1
        for tau in (1e-9, 1e-10, 3e-10):
            for alpha in (0.85, 0.9):
                res = pr.df_pagerank(g, g1, batch, r0, mode="lf",
                                     engine="blocked", tau=tau, alpha=alpha)
                assert res.converged
    assert bws._Library.builds == before


@pytest.mark.cuda
def test_cuda_thread_domain_session_equals_faults(cuda_device):
    """A snapshot-mode blocked session on the card: fault_domain=
    ThreadFaultDomain(plan) and faults=plan give bit-identical ranks, and
    the faulted run's counters equal the CPU session's."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.core.fault_domain import ThreadFaultDomain
    from repro_torch.core.faults import FaultPlan
    from repro_torch.graphs.generators import kmer_chains
    hg = kmer_chains(1 << 10, seed=4)
    plan = FaultPlan(n_threads=8, n_crashed=2, crash_window=4, seed=5)
    dels, ins = random_batch(hg, 5e-3, seed=7)
    res = {}
    for name, dev, kw in (("faults", cuda_device, dict(faults=plan)),
                          ("domain", cuda_device,
                           dict(fault_domain=ThreadFaultDomain(plan))),
                          ("cpu", "cpu", dict(faults=plan))):
        sess = PageRankSession.from_graph(hg, config=EngineConfig(
            engine="blocked", block_size=64, **kw), device=dev)
        res[name] = (sess.update(dels, ins), sess.R.cpu())
    assert torch.equal(res["faults"][1], res["domain"][1])
    assert res["faults"][0].stats == res["cpu"][0].stats
    assert res["faults"][0].converged
    assert float((res["faults"][1] - res["cpu"][1]).abs().max()) <= \
        TOLS[torch.float64]


def _tiered_pair(cuda_device, frac):
    """The same tiered stream on the card and on the CPU (f64, a fraction
    ``frac`` of the host pool's bytes as the budget)."""
    from repro_torch.api import EngineConfig, PageRankSession
    from repro_torch.core import tiering
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(32, seed=7)
    g0 = hg.snapshot(block_size=64, device="cpu")
    src, dst = g0.in_edges_host()
    pool = tiering.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                           block=64, dtype=np.float64)
    cfg = EngineConfig(block_size=64, tau=1e-10,
                       device_budget_bytes=int(pool.nbytes * frac))
    rng = np.random.default_rng(11)
    stream = [(np.zeros((0, 2), np.int64), rng.integers(0, hg.n, (16, 2)))
              for _ in range(3)]
    out = []
    for dev in (cuda_device, "cpu"):
        sess = PageRankSession.from_graph(hg, config=cfg, device=dev)
        sess.warmup()
        res = [sess.update(d, i) for d, i in stream]
        out.append((sess, res))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_cuda_tiered_session_matches_cpu(cuda_device, frac):
    """A tiered session on the card (the kernels reading the packed slab)
    against the same session on the CPU: the tiering counters, sweeps and
    edges equal, the ranks within 1e-12, no dense tile on the card."""
    (gs, gres), (cs, cres) = _tiered_pair(cuda_device, frac)
    launches = bsk.block_spmv_active_cuda.launches
    gt, ct = gs.report().tiering, cs.report().tiering
    for k in ("hits", "misses", "evictions", "admitted_tiles",
              "transfer_bytes", "refill_drives", "refill_stalls",
              "resident_blocks"):
        assert gt[k] == ct[k], k
    assert [r.stats.sweeps for r in gres] == [r.stats.sweeps for r in cres]
    assert [r.stats.edges_processed for r in gres] == \
        [r.stats.edges_processed for r in cres]
    assert np.abs(gs.ranks - cs.ranks).max() <= 1e-12
    assert gs.report().device_bytes["tile_pool"] == 0
    assert gs.hot.scrub() == []
    assert launches > 0
    if frac < 1.0:
        assert gt["evictions"] > 0 and gt["refill_drives"] > 0
    gs.close(), cs.close()


@pytest.mark.cuda
def test_cuda_kernels_read_the_slab_view(cuda_device):
    """Both kernels over a half-budget session's slab view (slab-slot tile
    ids, a packed index keyed by slot, no dense tiles) against their plain
    versions over the same view, and on the resident rows against the
    untiered matrix."""
    (gs, _), (cs, _) = _tiered_pair(cuda_device, 0.5)
    view = gs.inc.mat
    assert view.tiles.shape[0] == 0
    full = tops.build_block_sparse(*cs.hg.snapshot(
        block_size=64, device="cpu").in_edges_host()[::-1], view.n_rows,
        view.n_cols, block=64, dtype=torch.float64, padded=True,
        device=cuda_device)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random(view.n_cols)).to(cuda_device)
    rows = torch.repeat_interleave(gs.hot.rb_res, 64)
    for semiring in ("sum", "or"):
        xs = x if semiring == "sum" else (x < 0.2).double()
        kw = dict(block=64, max_tiles=view.max_tiles, semiring=semiring)
        got = bsk.block_spmv_cuda(view.tile_idx, view.tile_cols, view.index,
                                  xs, **kw)
        plain = bsk.block_spmv_plain(view.tile_idx, view.tile_cols,
                                     view.tiles, xs, index=view.index, **kw)
        torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)
        ref = tops.block_spmv(full, xs, semiring=semiring)
        torch.testing.assert_close(got[rows], ref[rows], rtol=1e-12,
                                   atol=1e-12)
        ids = torch.nonzero(gs.hot.rb_res).squeeze(1).to(torch.int32)
        act = bsk.block_spmv_active_cuda(ids, view.tile_idx, view.tile_cols,
                                         view.index, xs, **kw)
        torch.testing.assert_close(act[rows], ref[rows], rtol=1e-12,
                                   atol=1e-12)
    gs.close(), cs.close()


# ---------------------------------------------------------------------------
# paged edges (EdgePager) and the tiered push driver
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lf", "bb"])
@pytest.mark.parametrize("tile", [64, 512])
def test_cuda_paged_sweep_equals_unpaged(cuda_device, mode, tile):
    """The sweep kernel over a pager's slab (the slot list's blocks staged
    in another order than the CSR's) is bit-identical to the kernel over
    the snapshot's CSR, and equals the plain version over the same slab."""
    from repro_torch.core import blocked as blk
    from repro_torch.core import tiering
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    kw = dict(alpha=0.85, tau=1e-10, tau_f=1e-13, tile=tile, expand=True,
              jacobi=mode == "bb")
    for i, hg in enumerate(_sweep_graphs()):
        g = hg.snapshot(block_size=64, device="cpu")
        gc = hg.snapshot(block_size=64, device=cuda_device)
        R, aff, ids, mask = _sweep_inputs(g, torch.float64, seed=7 + i)
        live = ids.numpy()[(ids.numpy() >= 0) & mask.numpy()]
        staged = np.random.default_rng(i).permutation(live)
        pager = tiering.EdgePager(gc, budget_bytes=1 << 24)
        pager.ensure(staged[:len(staged) // 2])
        view = pager.ensure(live)
        cpu_view = tuple(t.cpu() for t in view)
        pg, pgc = tiering.paged_snapshot(g), tiering.paged_snapshot(gc)
        dev = [t.to(cuda_device) for t in (R, aff, ids, mask)]
        full = _run_sweep(bws.blocked_sweep_cuda,
                          blk.sweep_graph(gc, torch.float64), *dev, gc, **kw)
        paged = _run_sweep(bws.blocked_sweep_cuda,
                           blk.sweep_graph(pgc, torch.float64, view), *dev,
                           gc, **kw)
        plain = _run_sweep(bws.blocked_sweep_plain,
                           blk.sweep_graph(pg, torch.float64, cpu_view), R,
                           aff, ids, mask, g, **kw)
        torch.cuda.synchronize()
        for a, b in zip(full, paged):
            assert torch.equal(a, b)
        Rk, affk, rck, mk, ek = (t.cpu() for t in paged)
        Rp, affp, rcp, mp, ep = plain
        assert torch.equal(affk, affp) and torch.equal(rck, rcp)
        assert torch.equal(ek, ep)
        torch.testing.assert_close(Rk, Rp, rtol=0, atol=TOLS[torch.float64])


@pytest.mark.cuda
def test_cuda_paged_run_blocked_equals_unpaged(cuda_device):
    """``run_blocked(pager=)`` on the card: bit-equal to the unpaged run on
    the card, its counters and the pager's equal to the CPU's paged run."""
    from repro_torch.core import blocked as blk
    from repro_torch.core import frontier as fr
    from repro_torch.core import tiering
    from repro_torch.core.delta import random_batch
    from repro_torch.core.pagerank import numpy_reference
    from repro_torch.graphs.generators import grid_road
    hg0 = grid_road(48, seed=7)
    dels, ins = random_batch(hg0, 1e-3, seed=2, deletions_frac=0.2)
    out = {}
    for dev in ("cpu", cuda_device):
        g0 = hg0.snapshot(block_size=64, device=dev)
        g1 = hg0.apply_batch(dels, ins).snapshot(block_size=64, device=dev)
        aff = fr.initial_affected(g0, g1, fr.batch_to_device(g1, dels, ins))
        r_prev = torch.from_numpy(numpy_reference(g0, iterations=300))
        kw = dict(mode="lf", active_policy="rc", tau=1e-10)
        pager = tiering.EdgePager(g1, budget_bytes=16 * int(g1.m_pad))
        paged = blk.run_blocked(tiering.paged_snapshot(g1), r_prev, aff,
                                pager=pager, **kw)
        out[str(dev)] = (paged, blk.run_blocked(g1, r_prev, aff, **kw),
                         pager.stats())
    (pc, sc), _, stc = out["cpu"]
    (pg, sg), (ug, usg), stg = out[str(cuda_device)]
    assert torch.equal(pg, ug) and sg == usg
    assert sg == sc and stg == stc and stg["misses"] > 0
    assert float((pg.cpu() - pc).abs().max()) <= TOLS[torch.float64]


@pytest.mark.cuda
def test_cuda_tiered_push_session_matches_cpu(cuda_device):
    """A half-budget push session on the card (kernel #2 over the packed
    slab, the residual refresh included) against the same session on the
    CPU: tiering counters, sweeps, edges and pushed blocks equal, ranks
    within 1e-12, the residual within 1e-12 of host truth."""
    from repro_torch.api import EngineConfig, PageRankSession
    from repro_torch.core import tiering
    from repro_torch.core.push_engine import residual_from_host
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(32, seed=7)
    g0 = hg.snapshot(block_size=64, device="cpu")
    src, dst = g0.in_edges_host()
    pool = tiering.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                           block=64, dtype=np.float64)
    cfg = EngineConfig(block_size=64, tau=1e-10, driver="push",
                       device_budget_bytes=int(pool.nbytes) // 2)
    rng = np.random.default_rng(11)
    stream = [(np.zeros((0, 2), np.int64), rng.integers(0, hg.n, (16, 2)))
              for _ in range(3)]
    out = []
    launches = bsk.block_spmv_active_cuda.launches
    for dev in (cuda_device, "cpu"):
        sess = PageRankSession.from_graph(hg, config=cfg, device=dev)
        sess.warmup()
        out.append((sess, [sess.update(d, i) for d, i in stream]))
    (gs, gres), (cs, cres) = out
    assert bsk.block_spmv_active_cuda.launches > launches
    gt, ct = gs.report().tiering, cs.report().tiering
    for k in ("hits", "misses", "evictions", "admitted_tiles",
              "transfer_bytes", "refill_drives", "resident_blocks"):
        assert gt[k] == ct[k], k
    assert gt["refill_drives"] > 0 and gt["evictions"] > 0
    for a, b in zip(gres, cres):
        assert a.stats == b.stats and a.pushed_blocks == b.pushed_blocks
    assert np.abs(gs.ranks - cs.ranks).max() <= 1e-12
    host = residual_from_host(gs.hg, gs._out_deg_host, gs.ranks, 0.85)
    assert np.abs(gs._residual.cpu().numpy() - host).max() <= 1e-12
    gs.close(), cs.close()


@pytest.mark.cuda
def test_cuda_session_detects_and_heals_a_tile_flip(cuda_device):
    """A session on the card with ``integrity=``: the ``tile`` kind flips an
    entry of the packed index the kernels read (and of the dense pool);
    ``verify`` finds it through the index's row-block sums, the ``rebuild``
    rung re-converges through kernel #2 on the card, and the state ends
    clean and equal to the same session on the CPU after the same repair.
    A damaged index alone (the pool left as it was) is caught too."""
    from repro_torch.api import EngineConfig, IntegrityConfig, PageRankSession
    from repro_torch.core import integrity as ig
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(32, seed=7)
    cfg = EngineConfig(block_size=64, tau=1e-10,
                       integrity=IntegrityConfig(auto_repair=False))
    rng = np.random.default_rng(12)
    batch = (np.zeros((0, 2), np.int64), rng.integers(0, hg.n, (16, 2)))
    out = []
    for dev in (cuda_device, "cpu"):
        sess = PageRankSession.from_graph(hg, config=cfg, device=dev)
        sess.update(*batch)
        assert sess.verify(repair=False).ok
        sess.inject_corruption("tile", seed=3)
        mat = sess.inc.mat
        bad = np.abs(ig.check_packed_index(mat)[0] - sess.inc.aux.rb_in)
        assert (bad > ig.COUNT_TOL).sum() == 1
        launches = bsk.block_spmv_active_cuda.launches
        rep = sess.verify(repair=True)
        assert [f["check"] for f in rep.failures] == ["tile_sums"]
        assert rep.ok and rep.repairs == ["rebuild"]
        if dev != "cpu":
            assert bsk.block_spmv_active_cuda.launches > launches
        assert sess.verify(repair=False).ok
        out.append((sess, rep))
    (gs, grep_), (cs, crep) = out
    assert grep_.failures == crep.failures
    assert np.abs(gs.ranks - cs.ranks).max() <= 1e-12
    assert gs.report().integrity == cs.report().integrity
    # the index alone: one value flipped where no plain version reads
    idx = gs.inc.mat.index
    e = int(idx.off[3]) + 1
    idx.val[e] = 0.5
    rep = gs.verify(repair=True)
    assert {f["check"] for f in rep.failures} == {"tile_sums",
                                                  "packed_index"}
    assert rep.ok and rep.repairs == ["rebuild"]
    assert np.abs(gs.ranks - cs.ranks).max() <= 1e-12
    gs.close(), cs.close()


@pytest.mark.cuda
def test_cuda_launches_from_four_threads_count_exactly(cuda_device):
    """A service launches from one thread per slot: four threads on four
    streams race a library's first load (it loads once) and then launch
    both kernels; every launch is counted and no build is added."""
    import threading
    from repro_torch.kernels import nvcc
    fresh = nvcc.Library(bsk._SRC, "block_spmv", bsk._bind)
    try:
        gate = threading.Barrier(4)

        def first_load():
            gate.wait()
            fresh.load()

        threads = [threading.Thread(target=first_load) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert fresh.builds == 1
    finally:
        nvcc.Library._all.remove(fresh)
    n, block, reps = 2000, 64, 50
    rng = np.random.default_rng(4)
    mat = tops.build_block_sparse(rng.integers(0, n, 20000),
                                  rng.integers(0, n, 20000), n, n,
                                  block=block, dtype=torch.float64,
                                  padded=True, device=cuda_device)
    x = tops._pad_x(mat, torch.from_numpy(rng.random(n)).to(cuda_device))
    ids = torch.arange(mat.n_rb, dtype=torch.int32, device=cuda_device)
    kw = dict(block=block, max_tiles=mat.max_tiles)
    kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
    want = bsk.block_spmv_cuda(*kargs, **kw)
    want_a = bsk.block_spmv_active_cuda(ids, *kargs, **kw)
    torch.cuda.synchronize()
    before = (bsk.block_spmv_cuda.launches,
              bsk.block_spmv_active_cuda.launches, nvcc.total_builds())
    streams = [torch.cuda.Stream() for _ in range(4)]
    bad = []
    gate = threading.Barrier(4)

    def launch(s):
        gate.wait()
        with torch.cuda.stream(s):
            for _ in range(reps):
                y = bsk.block_spmv_cuda(*kargs, **kw)
                ya = bsk.block_spmv_active_cuda(ids, *kargs, **kw)
            s.synchronize()
        if not (torch.equal(y, want) and torch.equal(ya, want_a)):
            bad.append(s)

    threads = [threading.Thread(target=launch, args=(s,)) for s in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert (bsk.block_spmv_cuda.launches, bsk.block_spmv_active_cuda.launches,
            nvcc.total_builds()) == (before[0] + 4 * reps,
                                     before[1] + 4 * reps, before[2])


@pytest.mark.cuda
def test_cuda_service_slots_on_streams_match_cpu(cuda_device):
    """Two slots on their own streams in background mode, with reader
    threads, end where the same submits leave a synchronous CPU service;
    every read is served from a view that was ready."""
    import threading
    from repro_torch.api import EngineConfig, PageRankService, ServingConfig
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import rmat
    hg = rmat(9, avg_degree=6, seed=3)
    cfg = EngineConfig(block_size=64, tau=1e-10)
    batches, cur = [], hg
    for i in range(6):
        d, ins = random_batch(cur, 5e-3, seed=40 + i)
        batches.append((d, ins))
        cur = cur.apply_batch(d, ins)
    sv = ServingConfig(coalesce=False)
    cpu = PageRankService([hg, hg], config=cfg, serving=sv, device="cpu")
    gpu = PageRankService([hg, hg], config=cfg, serving=sv,
                          device=cuda_device)
    streams = {gpu._streams[0], gpu._streams[1]}
    assert len(streams) == 2
    assert torch.cuda.current_stream() not in streams
    for d, ins in batches:
        for i in range(2):
            cpu.submit(i, d, ins)
    cpu.run_until_drained()
    stop, reads, errors = threading.Event(), [], []

    def reader():
        try:
            while not stop.is_set():
                reads.append(np.asarray(gpu.query(0, [0, 1, 2])))
                gpu.top_k(1, 5)
        except Exception as e:   # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    gpu.start()
    for t in threads:
        t.start()
    try:
        for d, ins in batches:
            for i in range(2):
                gpu.submit(i, d, ins)
    finally:
        gpu.stop()
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors and reads
    rep = gpu.report()
    assert rep["requests_done"] == 12 and rep["retries"] == 0
    assert not any(r.error for r in gpu.finished)
    for i in range(2):
        assert np.abs(gpu.sessions[i].ranks
                      - cpu.sessions[i].ranks).max() <= 1e-12
        assert gpu.sessions[i].report().retraces_post_warmup == 0
    np.testing.assert_array_equal(np.asarray(gpu.query(0, [0, 1, 2])),
                                  gpu.sessions[0].query([0, 1, 2]))


def _walk_pair(device, R=8, L=24, seed=3):
    from repro_torch.core.walk_engine import WalkState
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(48, seed=7)
    return hg, (WalkState(hg, R=R, L=L, seed=seed, device="cpu"),
                WalkState(hg, R=R, L=L, seed=seed, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,seed", [(8, 24, 3), (1, 2, 0),
                                      (16, 48, 2 ** 32 + 5)])
def test_cuda_walk_regen_matches_plain(cuda_device, R, L, seed):
    """The full regeneration on the card equals the CPU's, and a partial
    one (walks through a patched row) equals the plain version on the same
    card operands: walks, counts and steps exact."""
    from repro_torch.kernels.walk import walk as wk
    hg, (cpu, gpu) = _walk_pair(cuda_device, R, L, seed)
    torch.cuda.synchronize()
    for name in ("walks", "counts", "adj", "deg"):
        assert torch.equal(getattr(cpu, name), getattr(gpu, name).cpu())
    wids = torch.arange(0, hg.n * R, 7, dtype=torch.int32,
                        device=cuda_device)
    adj = gpu.adj.clone()
    adj[:, 0] = adj[:, 1].clamp(max=hg.n)
    outs = []
    for fn in (wk.walk_regen_cuda, wk.walk_regen_plain):
        w, c = gpu.walks.clone(), gpu.counts.clone()
        steps = fn(w, c, adj, gpu.deg, wids, R=R, alpha=gpu._alpha32,
                   key=gpu._key)
        outs.append((w, c, int(steps)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] > 0


@pytest.mark.cuda
def test_cuda_walk_touch_matches_plain(cuda_device):
    from repro_torch.kernels.walk import walk as wk
    hg, (_, gpu) = _walk_pair(cuda_device, R=16, L=48)
    rng = np.random.default_rng(5)
    for n_touched in (1, 40, 900):
        tm = torch.zeros(hg.n + 1, dtype=torch.bool, device=cuda_device)
        tm[torch.as_tensor(rng.integers(0, hg.n, n_touched),
                           device=cuda_device)] = True
        f1, m1 = wk.walk_touch_cuda(gpu.walks, tm, n_walks=hg.n * 16)
        f2, m2 = wk.walk_touch_plain(gpu.walks, tm, n_walks=hg.n * 16)
        torch.cuda.synchronize()
        assert torch.equal(f1, f2) and int(m1) == int(m2) >= int(f1.sum())


def _reversed_rows(adj, deg):
    """Each adjacency row's real neighbours in reverse order (the sentinel
    tail kept): the walks through any vertex of out-degree > 1 move."""
    idx = torch.arange(adj.shape[1], device=adj.device)[None, :]
    d = deg[:, None].long()
    return adj.gather(1, torch.where(idx < d, d - 1 - idx, idx)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [3, 5, 130])
@pytest.mark.parametrize("B", [1, 31, 33])
def test_cuda_walk_regen_short_lists_and_odd_rows(cuda_device, L, B):
    """The lane-refill kernel on short unsorted id lists (fewer ids than a
    warp's lanes, and one more), the scratch id n*R among them for B > 1,
    at odd L (rows off the 16-byte grid) and L = 130, on reversed
    adjacency rows and under another seed's key (so rows grow and shrink):
    walks, counts and steps equal the plain version; the store's open
    (every id) equals the CPU's."""
    from repro_torch.core import threefry
    from repro_torch.kernels.walk import walk as wk
    R = 4
    hg, (cpu, gpu) = _walk_pair(cuda_device, R=R, L=L, seed=100 * L + B)
    torch.cuda.synchronize()
    assert torch.equal(cpu.walks, gpu.walks.cpu())
    assert torch.equal(cpu.counts, gpu.counts.cpu())
    nr = hg.n * R
    rng = np.random.default_rng(1000 * L + B)
    ids = rng.permutation(nr)[:B]
    if B > 1:
        ids[rng.integers(0, B)] = nr
    wids = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    adj = _reversed_rows(gpu.adj, gpu.deg)
    outs = []
    for fn in (wk.walk_regen_cuda, wk.walk_regen_plain):
        w, c = gpu.walks.clone(), gpu.counts.clone()
        steps = fn(w, c, adj, gpu.deg, wids, R=R, alpha=gpu._alpha32,
                   key=threefry.prng_key(100 * L + B + 1))
        outs.append((w, c, int(steps)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] > 0
    assert (outs[0][0][nr] == hg.n).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rmat", "widened", "offset"])
def test_cuda_walk_regen_adjacency_layouts(cuda_device, layout):
    """walk_regen on the adjacency layouts whose rows are read one entry at
    the pick rather than loaded whole with the degree: an R-MAT graph's
    (hubs of out-degree > 256, cap 512), the road graph's rows widened to
    16 slots (as a session's slab ladder widens them), and its cap-8 rows
    in a view 4 bytes past a 16-byte boundary.  On reversed rows under
    another seed's key, walks, counts and steps equal the plain version."""
    from repro_torch.core import threefry
    from repro_torch.core.walk_engine import WalkState
    from repro_torch.graphs.generators import grid_road, rmat
    from repro_torch.kernels.walk import walk as wk
    R, L = 4, 24
    hg = rmat(10, 16, seed=3) if layout == "rmat" else grid_road(48, seed=7)
    gpu = WalkState(hg, R=R, L=L, seed=11, device=cuda_device)
    adj = _reversed_rows(gpu.adj, gpu.deg)
    if layout == "widened":
        wide = torch.full((hg.n + 1, 16), hg.n, dtype=torch.int32,
                          device=cuda_device)
        wide[:, :adj.shape[1]] = adj
        adj = wide
    elif layout == "offset":
        flat = torch.empty(adj.numel() + 8, dtype=torch.int32,
                           device=cuda_device)
        at = (16 - flat.data_ptr() % 16) % 16 // 4 + 1
        view = flat[at:at + adj.numel()].view(adj.shape)
        view.copy_(adj)
        adj = view
        assert adj.data_ptr() % 16 == 4
    assert adj.shape[1] == {"rmat": 512, "widened": 16, "offset": 8}[layout]
    nr = hg.n * R
    wids = torch.as_tensor(np.random.default_rng(9).permutation(nr)[:4103],
                           dtype=torch.int32, device=cuda_device)
    outs = []
    for fn in (wk.walk_regen_cuda, wk.walk_regen_plain):
        w, c = gpu.walks.clone(), gpu.counts.clone()
        steps = fn(w, c, adj, gpu.deg, wids, R=R, alpha=gpu._alpha32,
                   key=threefry.prng_key(12))
        outs.append((w, c, int(steps)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] > 0
    assert not torch.equal(outs[0][0], gpu.walks)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("L", [5, 13, 48])
def test_cuda_walk_touch_row_shapes(cuda_device, L, shift):
    """walk_touch on crafted rows: rows with no sentinel (l = L), live
    prefixes ending at every place of a 32-byte sector and across sector
    boundaries, odd L (rows off the sector grid), touched vertices repeated
    and more than the four a row keeps in registers; from a buffer whose
    first row starts ``shift`` words past a 16-byte boundary.  Flags and
    mass equal the plain version."""
    from repro_torch.kernels.walk import walk as wk
    n, rows = 40, 4097
    rng = np.random.default_rng(L)
    lens = rng.integers(1, L + 1, rows)
    lens[:64] = L
    lens[64:64 + 2 * L] = np.arange(2 * L) % L + 1
    vals = rng.integers(0, n, (rows, L))
    vals[: rows // 2] %= 12                 # many repeats
    host = np.where(np.arange(L)[None, :] < lens[:, None], vals, n)
    host[-1] = n                            # the scratch row
    flat = torch.empty(rows * L + 8, dtype=torch.int32, device=cuda_device)
    at = (16 - flat.data_ptr() % 16) % 16 // 4 + shift
    walks = flat[at:at + rows * L].view(rows, L)
    walks.copy_(torch.as_tensor(host, dtype=torch.int32))
    assert walks.data_ptr() % 16 == 4 * shift
    for frac in (0.05, 0.5):
        tm = torch.zeros(n + 1, dtype=torch.bool, device=cuda_device)
        tm[:n] = torch.as_tensor(rng.random(n) < frac, device=cuda_device)
        tm[int(rng.integers(0, 12))] = True
        f1, m1 = wk.walk_touch_cuda(walks, tm, n_walks=rows - 1)
        f2, m2 = wk.walk_touch_plain(walks, tm, n_walks=rows - 1)
        torch.cuda.synchronize()
        assert torch.equal(f1, f2) and int(m1) == int(m2) > 0


@pytest.mark.cuda
def test_cuda_walk_session_matches_cpu(cuda_device):
    """A walk session on the card takes the CPU session's batches: walks,
    ranks, every update's walk fields and ``ppr_query`` equal; both kernels
    launched and no build after warmup."""
    from repro_torch.api import EngineConfig, PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road
    from repro_torch.kernels.walk import walk as wk
    hg = grid_road(48, seed=7)
    cfg = EngineConfig(engine="walk", walks_per_vertex=8, walk_length=32)
    cpu = PageRankSession.from_graph(hg, config=cfg, device="cpu")
    gpu = PageRankSession.from_graph(hg, config=cfg, device=cuda_device)
    gpu.warmup()
    launches = (wk.walk_regen_cuda.launches, wk.walk_touch_cuda.launches)
    cur = hg
    for i in range(4):
        d, ins = random_batch(cur, 2e-3, seed=70 + i)
        a, b = cpu.update(d, ins), gpu.update(d, ins)
        cur = cur.apply_batch(d, ins)
        assert (a.regenerated_walks, a.touched_walks,
                a.stats.edges_processed) == (b.regenerated_walks,
                                             b.touched_walks,
                                             b.stats.edges_processed)
    assert torch.equal(cpu.walks.walks, gpu.walks.walks.cpu())
    assert np.array_equal(cpu.ranks, gpu.ranks)
    for seeds in ([0], [5, 100, 2000]):
        for x, y in zip(cpu.ppr_query(seeds, 10), gpu.ppr_query(seeds, 10)):
            assert np.array_equal(x, y)
    assert wk.walk_regen_cuda.launches > launches[0]
    assert wk.walk_touch_cuda.launches >= launches[1] + 4
    assert gpu.report().retraces_post_warmup == 0
    view = gpu._read_view()
    assert np.array_equal(view.ppr_query([5], 10)[1],
                          gpu.ppr_query([5], 10)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("exchange,part", [("full", "contiguous"),
                                           ("delta", "hash"),
                                           ("full", "bfs_blocks")])
def test_cuda_sharded_session_matches_cpu(cuda_device, exchange, part):
    """An 8-shard session on the card takes the CPU session's batches:
    counters equal, ranks within 1e-12 (kernel #1's sums in another order);
    each sweep of a df update launches kernel #1 twice a shard (the pull and
    the or-expansion) and nothing else; ``recompute("df")`` replays the
    update bit for bit on the card; no build after warmup."""
    from repro_torch.api import EngineConfig, PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import rmat
    hg = rmat(12, avg_degree=6, seed=3)
    cfg = EngineConfig(topology="sharded", n_shards=8, partitioner=part,
                       exchange=exchange)
    cpu = PageRankSession.from_graph(hg, config=cfg, device="cpu")
    gpu = PageRankSession.from_graph(hg, config=cfg, device=cuda_device)
    assert np.abs(cpu.ranks - gpu.ranks).max() <= 1e-12
    gpu.warmup()
    cur = hg
    for i in range(4):
        d, ins = random_batch(cur, 2e-3, seed=900 + i)
        cur = cur.apply_batch(d, ins)
        active0 = bsk.block_spmv_active_cuda.launches
        full0 = bsk.block_spmv_cuda.launches
        a, b = cpu.update(d, ins), gpu.update(d, ins)
        assert (a.stats.sweeps, a.stats.edges_processed, a.converged) == \
            (b.stats.sweeps, b.stats.edges_processed, b.converged)
        assert bsk.block_spmv_cuda.launches - full0 == 16 * b.stats.sweeps
        assert bsk.block_spmv_active_cuda.launches == active0
        assert np.abs(cpu.ranks - gpu.ranks).max() <= 1e-12
    assert (cpu._x_full, cpu._x_delta) == (gpu._x_full, gpu._x_delta)
    replay = gpu.recompute("df")
    assert torch.equal(replay.ranks, b.ranks)
    assert gpu.report().retraces_post_warmup == 0
    vals, idx = gpu.top_k(5)
    assert np.array_equal(gpu.query(idx), vals)


@pytest.mark.cuda
def test_cuda_faulted_sharded_session_matches_cpu(cuda_device):
    """An 8-shard session on the card loses shard 3 after 2 sweeps of a df
    update (helped, then re-partitioned onto 7 shards) and stalls shard 2
    on a later one, as its CPU twin does: counters, the recovery events
    (but for their wall times) and the shard counts equal, ranks within
    1e-12; the recovery drive launches kernel #1 twice a shard a sweep."""
    from repro_torch.api import EngineConfig, PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import rmat
    hg = rmat(12, avg_degree=6, seed=3)
    cfg = EngineConfig(topology="sharded", n_shards=8)
    cpu = PageRankSession.from_graph(hg, config=cfg, device="cpu")
    gpu = PageRankSession.from_graph(hg, config=cfg, device=cuda_device)
    gpu.warmup()
    cur = hg
    for i in range(4):
        d, ins = random_batch(cur, 2e-3, seed=900 + i)
        cur = cur.apply_batch(d, ins)
        if i in (1, 3):
            for s in (cpu, gpu):
                s.inject_shard_fault(3 if i == 1 else 2, at_sweep=2,
                                     permanent=(i == 1))
        full0 = bsk.block_spmv_cuda.launches
        a, b = cpu.update(d, ins), gpu.update(d, ins)
        assert (a.stats.sweeps, a.stats.edges_processed, a.converged,
                a.host_syncs) == (b.stats.sweeps, b.stats.edges_processed,
                                  b.converged, b.host_syncs)
        assert b.driver_retraces == 0
        launched = bsk.block_spmv_cuda.launches - full0
        if i == 1:          # 2 sweeps on 8 shards, the rest on 7
            assert launched == 16 * 2 + 14 * (b.stats.sweeps - 2)
        assert np.abs(cpu.ranks - gpu.ranks).max() <= 1e-12
    rc, rg = cpu.report(), gpu.report()
    strip = lambda rep: [{k: v for k, v in e.items() if k != "wall_time_s"}
                         for e in rep.recovery_events]
    assert strip(rg) == strip(rc) and len(strip(rg)) == 2
    assert rg.recovery_events[0]["helped_vertices"] > 0
    assert rg.n_shards == rc.n_shards == 7
    assert gpu.device_footprint == (torch.cuda.current_device(),)
    assert (cpu._x_full, cpu._x_delta) == (gpu._x_full, gpu._x_delta)


# ---------------------------------------------------------------------------
# the GNN model zoo and the DF-incremental GNN update (no hand-written
# kernel: index_select / index_add_ / scatter_reduce and torch.matmul)
# ---------------------------------------------------------------------------

def _gnn_graph(n, e, d_feat, seed, **kw):
    from repro_torch.models.gnn import GraphBatch
    rng = np.random.default_rng(seed)
    return GraphBatch(
        nodes=torch.from_numpy(rng.normal(size=(n, d_feat)).astype(np.float32)),
        senders=torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        receivers=torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        pos=torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
        **kw)


def _gnn_to(g, dev):
    return g._replace(**{f: getattr(g, f).to(dev) for f in g._fields
                         if isinstance(getattr(g, f), torch.Tensor)})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["graphsage-reddit", "gatedgcn", "egnn",
                                  "meshgraphnet"])
def test_cuda_gnn_family_matches_cpu(cuda_device, arch):
    """Each family's forward and loss at a narrow config (3 layers, width
    32) on the card against the CPU, f32 both (rtol 1e-4, atol 1e-5: the
    card's unordered index_add_ and another GEMM order)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import get_family
    cfg = get_arch(arch).build_cfg(d_feat=24, n_out=5, task="node_clf",
                                   n_layers=3, d_hidden=32)
    mod = get_family(cfg)
    params = mod.init(cfg, 0, device="cpu")
    g = _gnn_graph(500, 3000, 24, seed=1)
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 5, 500))
    p_d = {k: v.to(cuda_device) for k, v in params.items()}
    g_d = _gnn_to(g, cuda_device)
    out_c, out_d = mod.forward(params, cfg, g), mod.forward(p_d, cfg, g_d)
    if cfg.family == "egnn":
        torch.testing.assert_close(out_d[1].cpu(), out_c[1], rtol=1e-4,
                                   atol=1e-5)
        out_c, out_d = out_c[0], out_d[0]
    torch.testing.assert_close(out_d.cpu(), out_c, rtol=1e-4, atol=1e-5)
    lc, _ = mod.loss_fn(params, cfg, g, labels)
    ld, _ = mod.loss_fn(p_d, cfg, g_d, labels.to(cuda_device))
    torch.testing.assert_close(ld.cpu(), lc, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_gnn_sampled_and_incremental_match_cpu(cuda_device):
    """GraphSAGE's sampled forward and the DF-incremental update on the card
    against the CPU: outputs within rtol 1e-4, atol 1e-5; the τ_f = 0
    update equals a full recompute on the card (rtol 1e-5, atol 1e-6)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import incremental as inc
    from repro_torch.data.pipeline import graphsage_minibatch_stream
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models.gnn import graphsage
    cfg = get_arch("graphsage-reddit").build_cfg(d_feat=16, n_out=4)
    params = graphsage.init(cfg, 0, device="cpu")
    p_d = {k: v.to(cuda_device) for k, v in params.items()}
    g = _gnn_graph(1000, 6000, 16, seed=3)
    sampler = NeighborSampler(1000, g.senders.numpy(), g.receivers.numpy())
    kw = dict(batch_nodes=32, fanouts=(5, 3), seed=4)
    feats, labels = g.nodes.numpy(), np.zeros(1000, np.int64)
    bc = next(graphsage_minibatch_stream(sampler, feats, labels,
                                         device="cpu", **kw))
    bd = next(graphsage_minibatch_stream(sampler, feats, labels,
                                         device=cuda_device, **kw))
    hc = [bc[f"hop{i}"] for i in range(3)]
    hd = [bd[f"hop{i}"] for i in range(3)]
    torch.testing.assert_close(graphsage.forward_sampled(p_d, cfg, hd).cpu(),
                               graphsage.forward_sampled(params, cfg, hc),
                               rtol=1e-4, atol=1e-5)
    fns_c = inc.full_gnn_layers(graphsage, params, cfg)
    fns_d = inc.full_gnn_layers(graphsage, p_d, cfg)
    g_d = _gnn_to(g, cuda_device)
    cache_c, cache_d = [g.nodes], [g_d.nodes]
    for fc, fd in zip(fns_c, fns_d):
        cache_c.append(fc(g, cache_c[-1]))
        cache_d.append(fd(g_d, cache_d[-1]))
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 6000, 8)
    old = np.stack([g.senders.numpy()[idx], g.receivers.numpy()[idx]], 1)
    g.senders[idx] = torch.from_numpy(rng.integers(0, 1000, 8).astype(np.int32))
    g.receivers[idx] = torch.from_numpy(
        rng.integers(0, 1000, 8).astype(np.int32))
    new = np.stack([g.senders.numpy()[idx], g.receivers.numpy()[idx]], 1)
    g_d = _gnn_to(g, cuda_device)
    for tau_f in (0.0, 1e-3):
        hc_, _, sc = inc.incremental_gnn_update(
            fns_c, g, g.nodes, cache_c,
            inc.edge_update_sources(1000, old, new, device="cpu"),
            tau_f=tau_f)
        hd_, _, sd = inc.incremental_gnn_update(
            fns_d, g_d, g_d.nodes, cache_d,
            inc.edge_update_sources(1000, old, new, device=cuda_device),
            tau_f=tau_f)
        torch.testing.assert_close(hd_.cpu(), hc_, rtol=1e-4, atol=1e-5)
        assert sd["total"] == sc["total"]
        assert sd["recomputed"] < sd["total"]
        if tau_f == 0.0:
            full = g_d.nodes
            for fd in fns_d:
                full = fd(g_d, full)
            torch.testing.assert_close(hd_, full, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the ordered GNN segment sum on the card (ROADMAP C 12)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_segment_sum_is_the_cpu_sum_bit_for_bit(cuda_device):
    """The card adds each destination's messages in edge order, as the CPU
    does: equal bits on data where another order rounds differently, 2-D
    and 1-D messages, int32 and int64 ids; once the order is kept, a sum
    reads nothing back to the host."""
    from repro_torch.models.gnn import common as C
    rng = np.random.default_rng(0)
    n, e = 300, 60000
    rcv = torch.from_numpy(rng.integers(0, n + 1, e).astype(np.int32))
    msg = torch.from_numpy((rng.normal(size=(e, 8))
                            * 10.0 ** rng.integers(-4, 9, (e, 1))
                            ).astype(np.float32))
    for ids in (rcv, rcv.long()):
        ids_d = ids.to(cuda_device)
        for x in (msg, msg[:, 0].contiguous()):
            want = C._segment_sum(x, ids, n + 1)
            got = C._segment_sum(x.to(cuda_device), ids_d, n + 1)
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))
        # with the order kept, a sum makes no host sync
        x_d = msg.to(cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            C._segment_sum(x_d, ids_d, n + 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_gnn_update_stats_at_tau_zero_equal_the_cpu(cuda_device):
    """Over a 3-batch stream of edges rewired in place, the τ_f = 0
    DF-incremental update's stats on the card equal the CPU's (each side
    from its own exact cache), and two full passes on the card are equal
    bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.core import incremental as inc
    from repro_torch.models.gnn import graphsage
    cfg = get_arch("graphsage-reddit").build_cfg(d_feat=16, n_out=4)
    params = graphsage.init(cfg, 0, device="cpu")
    p_d = {k: v.to(cuda_device) for k, v in params.items()}
    n, e = 3000, 40000
    g = _gnn_graph(n, e, 16, seed=11)
    g_d = _gnn_to(g, cuda_device)
    fns_c = inc.full_gnn_layers(graphsage, params, cfg)
    fns_d = inc.full_gnn_layers(graphsage, p_d, cfg)

    def full_pass(gr, fns):
        cache = [gr.nodes]
        for fn in fns:
            cache.append(fn(gr, cache[-1]))
        return cache

    cache_c, cache_d = full_pass(g, fns_c), full_pass(g_d, fns_d)
    again = full_pass(g_d, fns_d)
    assert all(torch.equal(a, b) for a, b in zip(cache_d, again))
    rng = np.random.default_rng(12)
    for _ in range(3):
        # rewired in place through torch on both sides (the host's final
        # values where an index repeats)
        idx = torch.from_numpy(rng.integers(0, e, 40))
        old = np.stack([g.senders[idx].numpy(), g.receivers[idx].numpy()], 1)
        g.senders[idx] = torch.from_numpy(rng.integers(0, n, 40)).int()
        g.receivers[idx] = torch.from_numpy(rng.integers(0, n, 40)).int()
        new = np.stack([g.senders[idx].numpy(), g.receivers[idx].numpy()], 1)
        g_d.senders[idx.to(cuda_device)] = g.senders[idx].to(cuda_device)
        g_d.receivers[idx.to(cuda_device)] = g.receivers[idx].to(cuda_device)
        _, _, st_c = inc.incremental_gnn_update(
            fns_c, g, g.nodes, cache_c,
            inc.edge_update_sources(n, old, new, device="cpu"), tau_f=0.0)
        _, _, st_d = inc.incremental_gnn_update(
            fns_d, g_d, g_d.nodes, cache_d,
            inc.edge_update_sources(n, old, new, device=cuda_device),
            tau_f=0.0)
        assert st_d == st_c
        assert st_d["recomputed"] < st_d["total"]
        cache_c, cache_d = full_pass(g, fns_c), full_pass(g_d, fns_d)
        again = full_pass(g_d, fns_d)
        assert all(torch.equal(a, b) for a, b in zip(cache_d, again))


# ---------------------------------------------------------------------------
# the LM transformer on the card
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen1.5-4b", "phi4-mini-3.8b", "nemotron-4-340b",
            "granite-moe-3b-a800m", "mixtral-8x22b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_matches_cpu(cuda_device, arch):
    """Each LM config at its smoke shape: ``forward``, ``loss_fn``,
    ``prefill`` and two ``decode_step`` s on the card against the CPU, f32
    both (rtol 1e-4, atol 1e-4, as the CPU twins hold the port to JAX);
    mixtral's prompt outgrows its 32-slot ring."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as TM
    cfg = get_arch(arch).smoke_cfg()
    params = TM.init_params(cfg, 0, device="cpu")
    p_d = {k: v.to(cuda_device) for k, v in params.items()}
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 42)))
    lab = torch.from_numpy(rng.integers(-1, cfg.vocab, (2, 42)))
    tol = dict(rtol=1e-4, atol=1e-4)
    lc, ac = TM.forward(params, tok, cfg)
    ld, ad = TM.forward(p_d, tok.to(cuda_device), cfg)
    torch.testing.assert_close(ld.cpu(), lc, **tol)
    torch.testing.assert_close(ad.cpu(), ac, rtol=1e-5, atol=1e-6)
    xc, _ = TM.loss_fn(params, tok, lab, cfg)
    xd, _ = TM.loss_fn(p_d, tok.to(cuda_device), lab.to(cuda_device), cfg)
    torch.testing.assert_close(xd.cpu(), xc, rtol=1e-5, atol=1e-5)
    pc, cc = TM.prefill(params, tok[:, :40], cfg, cache_len=44)
    pd, cd = TM.prefill(p_d, tok[:, :40].to(cuda_device), cfg, cache_len=44)
    torch.testing.assert_close(pd.cpu(), pc, **tol)
    for j in (40, 41):
        pc, cc = TM.decode_step(params, cc, tok[:, j], j, cfg)
        pd, cd = TM.decode_step(p_d, cd, tok[:, j].to(cuda_device), j, cfg)
        torch.testing.assert_close(pd.cpu(), pc, **tol)
        for k in ("k", "v"):
            torch.testing.assert_close(cd[k].cpu(), cc[k], **tol)


@pytest.mark.cuda
def test_cuda_f8_cache_cast_and_top_k_equal_the_cpu(cuda_device):
    """The f8 cache cast on the card gives the CPU's bytes (beyond ±464,
    ±inf and NaN too, from f32 and bf16), and ``top_k`` breaks the same
    ties."""
    from repro_torch.models.transformer import layers as TL
    rng = np.random.default_rng(2)
    v = np.concatenate([np.linspace(-600, 600, 24001, dtype=np.float32),
                        np.array([np.inf, -np.inf, np.nan, 464.0, 464.01,
                                  -464.01, 1e38], np.float32),
                        (rng.normal(size=50000) * 300).astype(np.float32),
                        (rng.normal(size=50000) * 2.0 ** -8
                         ).astype(np.float32)])
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(v).to(dt)
        want = TL.cache_cast(x, torch.float8_e4m3fn).view(torch.uint8)
        got = TL.cache_cast(x.to(cuda_device), torch.float8_e4m3fn)
        assert torch.equal(got.view(torch.uint8).cpu(), want)
    probs = torch.from_numpy(rng.integers(0, 4, (500, 40)).astype(
        np.float32) / 8)
    for k in (1, 2, 8):
        vc, ic = TL.top_k(probs, k)
        vd, id_ = TL.top_k(probs.to(cuda_device), k)
        assert torch.equal(id_.cpu(), ic) and torch.equal(vd.cpu(), vc)
