"""Deterministic record/replay of chaos runs on both planes: the
recording format (``recording``), the membership-view digests
(``digest``: per round on the device, per barrier on the host), the
replayer (``replayer``), the differ (``differ``) and the determinism
self-check (``selfcheck``).  Recordings interchange with the reference
package's both ways."""
