"""Checkpoints and the durable-session store of the port (ports
``src/repro/ckpt``)."""
