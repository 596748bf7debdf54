"""Distributed substrate of the port: so far the wire-compression
primitives (:mod:`repro_torch.dist.compression`)."""
