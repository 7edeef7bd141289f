"""Re-execute a device recording and re-derive its digest stream.

Counterpart of ``replay_device`` in ``serf_tpu/replay/replayer.py``:
the mask schedule is rebuilt from the recorded plan (``lower_plan`` is
pure), the recorded injection batches are consumed verbatim (so a
perturbed recording replays perturbed), and the phase scans re-run with
the recorded key material, emitting the same per-round digests and, on
controlled runs, the same control decisions.  Replay of an unmodified
recording is bit-exact; a recording made by the reference package
replays here, and this package's recordings replay there.
"""

from __future__ import annotations

import numpy as np
import torch

from serf_tpu_torch import prng, resolve_device
from serf_tpu_torch.faults.device import (
    control_base_row,
    inject_chunk,
    lower_plan,
    run_phase,
)
from serf_tpu_torch.models.swim import _check_slice, make_cluster
from serf_tpu_torch.replay.recording import (
    NODE_DIGEST_CAP,
    Recording,
    RecordingError,
    RunRecorder,
    device_config_from_dict,
    key_from_hex,
    plan_from_dict,
    record_scan_controls,
    record_scan_views,
)


def replay_device(rec: Recording, mesh=None, device=None) -> RunRecorder:
    """Re-execute a device recording on ``device`` (default ``"cuda"``);
    returns the replay's recorder (diff its ``to_recording()`` against
    the source with ``differ.diff_recordings``)."""
    _check_slice(mesh)
    if rec.plane != "device":
        raise RecordingError(
            f"replay_device on a {rec.plane!r}-plane recording")
    dev = resolve_device(device)
    plan = plan_from_dict(rec.header["plan"])
    cfg = device_config_from_dict(rec.header["config"])
    sched = lower_plan(plan, cfg.n, dev)
    out = RunRecorder()
    out.header(plane="device", plan=rec.header["plan"],
               seed=rec.header["seed"], config=rec.header["config"])

    state = None
    init_alive = None
    no_group = torch.zeros((cfg.n,), dtype=torch.int32, device=dev)
    no_down = torch.zeros((cfg.n,), dtype=torch.bool, device=dev)
    no_drop = torch.zeros((), dtype=torch.float32, device=dev)
    total = 0
    want_ctl = cfg.control.enabled
    ctl_prev = control_base_row(cfg) if want_ctl else None
    include_nodes = cfg.n <= NODE_DIGEST_CAP
    for s in rec.steps():
        op, a = s["op"], s["args"]
        if op == "init":
            if int(a.get("mesh_devices", 1)) > 1:
                raise NotImplementedError(
                    "not yet ported: replaying a sharded recording")
            state = make_cluster(cfg, key_from_hex(a["key"]), device=dev)
            init_alive = state.gossip.alive
            out.step("init", **a)
        elif op == "inject":
            if state is None:
                raise RecordingError("inject step before init")
            # eids/ltimes/origins verbatim; the admission gate re-runs on
            # the same deterministic control state
            eids = prng.to_device(np.asarray(a["eids"], np.int32), dev)
            ltimes = prng.to_device(
                np.asarray(a["ltimes"], np.uint32).view(np.int32), dev)
            origins = prng.to_device(np.asarray(a["origins"], np.int32),
                                     dev)
            state = inject_chunk(state, cfg, eids, ltimes, origins,
                                 want_ctl, int(a["kind"]))
            out.step("inject", **a)
        elif op == "scan":
            if state is None:
                raise RecordingError("scan step before init")
            pi = int(a["phase"])
            num_rounds = int(a["rounds"])
            out.step("scan", **a)
            state, aux = run_phase(
                state, cfg, key_from_hex(a["key"]), num_rounds,
                sched.group[pi] if pi >= 0 else no_group,
                sched.drop[pi] if pi >= 0 else no_drop,
                init_alive, sched.down[pi] if pi >= 0 else no_down,
                collect_digests=True, include_nodes=include_nodes,
                collect_control=want_ctl)
            if want_ctl:
                (dg, dn), crows = aux
            else:
                dg, dn = aux
            record_scan_views(out, total, dg, dn, include_nodes)
            if want_ctl:
                ctl_prev = record_scan_controls(
                    out, total, crows.cpu().numpy(), ctl_prev)
            total += num_rounds
        elif op == "control":
            # derived state, not ingress: the replay emitted its own
            # decisions above; the recorded ones are the comparison
            continue
        else:
            raise RecordingError(f"unknown device step op {op!r}")
    out.finish()
    return out
