"""The hand-written CUDA kernels against their plain PyTorch versions, and
a stream on the card against the same stream on the CPU.

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
    torch.testing.assert_close(bsk.block_spmv_cuda(*args, **kw),
                               bsk.block_spmv_plain(*args, **kw),
                               rtol=tol, atol=tol)
    act = torch.arange(0, mat.n_rb, 2, dtype=torch.int32)
    ids = torch.full((mat.n_rb,), -1, dtype=torch.int32)
    ids[:len(act)] = act
    ids = ids.to(cuda_device)
    out = torch.full((mat.n_rb * block,), float("nan"), dtype=t_dt,
                     device=cuda_device)
    ya = bsk.block_spmv_active_cuda(ids, *args, out=out, **kw)
    yp = bsk.block_spmv_active_plain(ids, *args, **kw)
    live = torch.zeros(mat.n_rb, dtype=torch.bool)
    live[act.long()] = True
    live = live.repeat_interleave(block).to(cuda_device)
    torch.testing.assert_close(ya[live], yp[live], rtol=tol, atol=tol)
    assert bool(torch.isnan(ya[~live]).all())


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
