"""The host plane of the port: what is ported so far.

The wire path, as the reference's ``serf_tpu/host`` has it: the SWIM
messages (``host.messages``), the compress → checksum pipeline
(``host.wire``), the keyring's encryption (``host.keyring``), and the
Vivaldi coordinate client (``host.coordinate``).  The engine itself
(``Serf``, ``Memberlist``) and the transports wait for the next slice.
"""

from serf_tpu_torch.host.coordinate import (
    Coordinate,
    CoordinateClient,
    CoordinateOptions,
)
from serf_tpu_torch.host.keyring import SecretKeyring

__all__ = [
    "SecretKeyring",
    "Coordinate",
    "CoordinateClient",
    "CoordinateOptions",
]
