"""The chaos plane: seeded fault plans (``plan``) and their three
executors over the same plan objects: the device executor (``device``:
per-round masks in the flagship round), the in-process host executor
(``host``: a loopback cluster, with the real-transport chaos seam the
serf agent arms) and the process executor (``proc``: agent processes on
real sockets); the invariants judged after a run (``invariants``)."""
