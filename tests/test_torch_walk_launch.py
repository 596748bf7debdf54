"""``walk_regen``'s launch shape (``repro_torch.kernels.walk.walk.
regen_launch``), which the CUDA wrapper passes to the kernel: a persistent
grid of one wave whose warps take 32 list entries at a time (warp g of W
takes chunks g, g + W, ...).  For lists of 1 to 16,777,216 ids (the walk
open at n = 1,048,576, R = 16) on three cards: every id lies in exactly
one chunk of exactly one warp, no block is left without a chunk, the
warps' chunk counts differ by at most one, and the grid fits in one wave
of the card.  The shape does not depend on the row length L: the kernel
takes no shared memory at any L (a lane stages its row's open quad in
registers); its rows of 2 to 130 entries are held to the plain version in
``tests/test_torch_cuda.py``.  CPU only.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.walk import walk as wk

CARDS = [(132, 4), (132, 1), (1, 1)]      # (SMs, resident blocks an SM)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk_owners(shape: wk.RegenLaunch, B: int) -> np.ndarray:
    """owner[c] = the warp that takes chunk c by the kernel's rule (warp g
    of W takes chunks g, g + W, ...), -1 if none; raises if two warps take
    one chunk."""
    n_chunks = -(-B // wk.REGEN_CHUNK)
    W = shape.grid * shape.warps
    owner = np.full(n_chunks, -1, np.int64)
    for g in range(W):
        mine = np.arange(g, n_chunks, W)
        assert (owner[mine] == -1).all(), f"chunk taken twice (warp {g})"
        owner[mine] = g
    return owner


@pytest.mark.parametrize("sms,bps", CARDS)
@pytest.mark.parametrize("B", [1, 31, 32, 33, 4103, 16_777_216])
def test_regen_launch_covers_every_id_once(B, sms, bps):
    shape = wk.regen_launch(B, sms, bps)
    assert wk.REGEN_CHUNK == 32
    assert 1 <= shape.warps <= wk.REGEN_WARPS
    assert 1 <= shape.grid <= sms * bps          # one wave
    owner = _chunk_owners(shape, B)
    assert (owner >= 0).all()                    # every chunk taken
    # the chunks' id ranges tile [0, B) once
    lo = np.arange(owner.size) * wk.REGEN_CHUNK
    hi = np.minimum(lo + wk.REGEN_CHUNK, B)
    assert lo[0] == 0 and hi[-1] == B and (lo[1:] == hi[:-1]).all()
    # no block without a chunk; the warps' loads differ by at most one
    blocks = np.unique(owner // shape.warps)
    assert blocks.size == shape.grid
    per_warp = np.bincount(owner, minlength=shape.grid * shape.warps)
    taken = per_warp[per_warp > 0]
    assert taken.max() - taken.min() <= 1


def test_regen_launch_fills_the_card_for_the_open():
    """The open's 524,288 chunks fill one wave of every resident block."""
    shape = wk.regen_launch(16_777_216, 132, 4)
    assert (shape.grid, shape.warps) == (528, wk.REGEN_WARPS)
    assert (_chunk_owners(shape, 16_777_216) == 0).sum() == \
        -(-524_288 // (528 * 8))


@pytest.mark.parametrize("B,sms,bps", [(0, 132, 4), (5, 0, 4), (5, 132, 0)])
def test_regen_launch_rejects_bad_shapes(B, sms, bps):
    with pytest.raises(ValueError, match="regen_launch"):
        wk.regen_launch(B, sms, bps)
