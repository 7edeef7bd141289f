"""Deterministic record/replay of device chaos runs: the recording format
(``recording``), the per-round membership-view digests (``digest``), the
replayer (``replayer``), the differ (``differ``) and the determinism
self-check (``selfcheck``).  Recordings interchange with the reference
package's both ways."""
