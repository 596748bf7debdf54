"""PyTorch/CUDA port of the lock-free Dynamic Frontier PageRank system.

The JAX package ``repro`` is the reference; this package ports it slice by
slice with the same module paths and names.  This slice: the untiered,
pull-driver, stream-mode :class:`repro_torch.api.session.PageRankSession` on
two hand-written CUDA tile-SpMV kernels
(:mod:`repro_torch.kernels.block_spmv.block_spmv`).  Entry points place
their state on ``device="cuda"`` by default and raise without a card unless
the caller passes ``device="cpu"`` (:mod:`repro_torch.device`).
"""
