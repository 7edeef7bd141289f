"""serfd: the serf agent entry point (one cluster member per process).

A thin wrapper over ``serf_tpu_torch.host.agent``:

    python -m serf_tpu_torch.tools.serfd --config agent.json

The config file is an ``AgentConfig`` JSON document::

    {
      "node_id": "p0",
      "bind": "127.0.0.1:0",
      "ctl": "127.0.0.1:0",
      "join": ["127.0.0.1:7946"],
      "snapshot_path": "/var/lib/serf/p0.snap",
      "ready_file": "/run/serf/p0.ready",
      "profile": "lan",
      "options": {"memberlist": {"probe_interval": "1s"}}
    }

``bind``/``ctl`` port 0 means ephemeral; once live the agent atomically
writes the ready file with the bound addresses, pid and restart
generation.  SIGTERM leaves gracefully (peers see Left, the snapshot
flushes the leave record); the control channel speaks the length-framed
JSON protocol in ``serf_tpu_torch.host.ctl``.  The agent is host plane
only: it imports no torch, runs on the CPU and never touches the card.
"""

import sys

from serf_tpu_torch.host.agent import main

if __name__ == "__main__":
    sys.exit(main())
