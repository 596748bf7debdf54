"""Model zoo of the port (ports ``src/repro/models``): the GNN families.
The transformer and recsys families are not ported yet (ROADMAP A 15a)."""
