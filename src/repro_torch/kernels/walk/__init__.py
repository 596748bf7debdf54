"""The walk engine's kernels (``walk_regen``, ``walk_touch``): CUDA and
their plain versions (port ``src/repro/core/walk_engine.py::_regen_step``
and take the place of its host reverse index)."""
