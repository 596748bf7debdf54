"""Block-sparse tile SpMV: layout, builder and kernels (ports
``src/repro/kernels/block_spmv``)."""
