"""The chaos plane: seeded fault plans (``plan``), their lowering to
per-round masks and the device executor (``device``), the invariants
judged after a run (``invariants``), and the real-transport chaos seam
the serf agent arms (``host.attach_transport_chaos``)."""
