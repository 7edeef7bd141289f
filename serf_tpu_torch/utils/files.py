"""Crash-safe file writes: write-tmp-fsync-rename, never a torn file.

The port's copy of ``serf_tpu/utils/files.py``.  A process killed
mid-``write()`` must never leave a half-written file a restart then
trusts: every durable single-file artifact (keyring saves first of all)
goes through :func:`atomic_write_bytes`, which stages
the content in a same-directory temp file, fsyncs it, and publishes it
with ``os.replace`` (atomic on POSIX).  A crash before the rename leaves
the OLD file intact; a crash after leaves the NEW one complete.
"""

from __future__ import annotations

import os
import tempfile


def atomic_write_bytes(path: str, data: bytes, mode: int = 0o644) -> None:
    """Atomically publish ``data`` at ``path`` (tmp + fsync + rename).
    The temp file lives in the target's directory so the rename never
    crosses a filesystem boundary (which would silently degrade to a
    non-atomic copy)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        os.fchmod(fd, mode)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # the staged temp must not survive a failed publish — but the
        # target itself is untouched either way (that is the contract)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str, mode: int = 0o644) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), mode=mode)
