"""Determinism self-check: record a short seeded device run, replay it,
and require equal digests every round."""

from __future__ import annotations

from typing import Any, Dict


def default_replay_cfg(n: int = 48, k_facts: int = 32, **gossip_kw):
    """The small-N device config every replay surface shares (the
    reference's values)."""
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.swim import ClusterConfig

    return ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k_facts,
                            peer_sampling="rotation", **gossip_kw),
        failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=8)


def device_roundtrip(n: int = 48, k_facts: int = 32,
                     device=None) -> Dict[str, Any]:
    """Record the ``self-check`` plan on ``device`` (default ``"cuda"``),
    replay it there, and diff the digest streams."""
    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import RunRecorder
    from serf_tpu_torch.replay.replayer import replay_device

    plan = named_plan("self-check")
    cfg = default_replay_cfg(n, k_facts)
    recorder = RunRecorder()
    result = run_device_plan(plan, cfg, recorder=recorder, device=device)
    recording = recorder.to_recording()
    replayed = replay_device(recording, device=device).to_recording()
    d = diff_recordings(recording, replayed)
    return {
        "plan": plan.name,
        "n": n,
        "rounds": d.compared_views,
        "digest_equal": d.ok,
        "first_divergent_round": d.first_divergent_round,
        "invariants_ok": bool(result.report.ok),
    }
