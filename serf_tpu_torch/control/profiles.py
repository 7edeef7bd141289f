"""Chaos A/B configuration profiles for the adaptive control plane.

A chaos A/B runs a plan twice: the STATIC config (controller off) and
its CONTROLLED twin.  The two named control plans
(``control-loss-converge`` / ``control-overload-shed``) carry profiles
in which the static run breaches an SLO while the controlled run comes
back all-green; every other plan runs the default chaos config against
itself plus the controller.  The two legs share every protocol constant
except the controller's headroom, so the A/B isolates the control law.
"""

from __future__ import annotations

from typing import Optional, Tuple

from serf_tpu_torch.control.device import ControlConfig
from serf_tpu_torch.control.host import HostControlConfig


def device_ab_config(plan_name: str, n: int, k_facts: int,
                     controlled: bool):
    """The device-plane ClusterConfig for one leg of a chaos A/B (the
    reference's field values exactly)."""
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.swim import ClusterConfig

    if plan_name == "control-loss-converge":
        # convergence isolation: anti-entropy and detection off; static
        # fan-out 1 is the breach, the controlled twin starts at 1 with
        # headroom to 4
        return ClusterConfig(
            gossip=GossipConfig(n=n, k_facts=k_facts,
                                fanout=4 if controlled else 1,
                                peer_sampling="rotation"),
            failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                  probe_schedule="round_robin"),
            push_pull_every=0, with_failure=False, with_vivaldi=False,
            control=ControlConfig(enabled=controlled, fanout_base=1))
    if plan_name == "control-overload-shed":
        # overload: storms far past ring capacity; both legs run
        # quarter-deferred stamp flushes at base unit 2, so the stamp
        # knob can move both ways under control
        return ClusterConfig(
            gossip=GossipConfig(n=n, k_facts=k_facts,
                                peer_sampling="rotation",
                                stamp_flush_unit=2),
            failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                  probe_schedule="round_robin"),
            push_pull_every=8,
            control=ControlConfig(enabled=controlled))
    # any other plan: the default chaos config, plus the controller with
    # stock clamps on the controlled leg (fan-out headroom 3 -> 4)
    return ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k_facts,
                            fanout=4 if controlled else 3,
                            peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=8,
        control=ControlConfig(enabled=controlled, fanout_base=3))


def host_ab_profile(plan_name: str, controlled: bool
                    ) -> Tuple[Optional[object],
                               Optional[HostControlConfig]]:
    """(opts, control_cfg) for one host-plane A/B leg.  ``opts=None``
    keeps the executor defaults."""
    if plan_name == "control-overload-shed":
        from serf_tpu_torch.options import Options

        # deliberately conservative static buckets: rate-2 trickle +
        # burst 2 per node against a 900 ops/s storm -> the static leg
        # sheds >95% of offered load (shed-ratio breach); the controller
        # may widen up to 8x while health holds
        opts = Options.local(
            user_event_rate=2.0, user_event_burst=2,
            query_rate=2.0, query_burst=2,
            max_query_responses=64,
            event_queue_bytes=256 * 1024,
            query_queue_bytes=128 * 1024,
            event_inbox_max=2048,
        )
        return opts, (HostControlConfig(enabled=True, hyst_up=2,
                                        hyst_down=8, step=1.6,
                                        max_scale=8.0)
                      if controlled else None)
    return None, (HostControlConfig(enabled=True) if controlled else None)
