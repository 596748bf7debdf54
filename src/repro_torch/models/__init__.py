"""Model zoo of the port (ports ``src/repro/models``): the GNN families and
the LM transformer.  The recsys family is not ported yet (ROADMAP A 15a)."""
