"""The device chaos plane: seeded fault plans (``plan``), their lowering
to per-round masks and the executor (``device``), and the invariants
judged after a run (``invariants``)."""
