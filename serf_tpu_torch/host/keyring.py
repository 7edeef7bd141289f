"""Secret keyring: AEAD packet/stream encryption with rotatable keys.

The port's copy of ``serf_tpu/host/keyring.py``: the same names and bytes.

Reference capability: memberlist's ``SecretKey``/keyring with AES encryption,
orchestrated cluster-wide by serf's key manager (SURVEY.md §2.7/§2.9).
Encrypt with the primary key; decrypt by trying the primary FIRST and then
every secondary key in install order, so the cluster stays connected
mid-rotation — a fallback hit (a peer still encrypting with an older/newer
primary) is counted on ``serf.keyring.decrypt_fallback`` and a miss across
the whole ring on ``serf.keyring.decrypt_fail``.

Wire format: ``[0x01 version][12-byte nonce][ciphertext+tag16]`` (the
``ENCRYPTION_FRAME_SCHEMA`` literal below is the shape the reference's
serflint pins).

Backends: AES-GCM via the ``cryptography`` wheel when available, else a
pure-stdlib AEAD (SHA-256 keystream in CTR construction + encrypt-then-MAC
HMAC-SHA256 tag truncated to 16 bytes over ``nonce||ct||aad``) with the
identical frame layout.  The fallback exists so images without the wheel
still run encrypted clusters end-to-end (chaos plans, proc agents, tests);
it is NOT wire-compatible with the AES-GCM backend — a cluster must run one
backend, which ``CRYPTO_BACKEND`` names.
"""

from __future__ import annotations

import binascii
import hashlib
import hmac as _hmac
import json
import os
import threading
from base64 import b64decode, b64encode
from typing import List, Optional

from serf_tpu_torch.utils import metrics

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    CRYPTO_BACKEND = "aes-gcm"
except ImportError:  # pragma: no cover - environment-dependent
    # Encryption stays a live capability without the wheel: the stdlib
    # AEAD below takes over with the same frame layout (same-backend
    # clusters only; CRYPTO_BACKEND tells operators which one runs).
    AESGCM = None
    CRYPTO_BACKEND = "hmac-sha256-ctr"

ENCRYPTION_VERSION = 1
KEY_SIZES = (16, 24, 32)
NONCE_SIZE = 12
TAG_SIZE = 16

#: the crypto framing the reference's serflint pins into its wire
#: fingerprint; the port keeps the same literal, so the frames
#: interchange.
ENCRYPTION_FRAME_SCHEMA = {
    "encrypted-frame": ("version=0x01", "nonce[12]", "ciphertext||tag[16]"),
    "encrypt-pipeline": ("encode", "compress", "checksum", "encrypt"),
    "batch-encryption": ("one-encrypt-per-BATCH-frame",
                         "gossip-fanout-amortized"),
}


class KeyringError(Exception):
    pass


# --------------------------------------------------------------------------
# AEAD backends: AES-GCM when the wheel exists, stdlib HMAC-CTR otherwise
# --------------------------------------------------------------------------

def _ctr_xor(key: bytes, nonce: bytes, data: bytes) -> bytes:
    """SHA-256 keystream in counter mode: block i = H(key||nonce||i)."""
    out = bytearray(len(data))
    for block in range((len(data) + 31) // 32):
        ks = hashlib.sha256(
            key + nonce + block.to_bytes(4, "big")).digest()
        lo = block * 32
        chunk = data[lo:lo + 32]
        for j, b in enumerate(chunk):
            out[lo + j] = b ^ ks[j]
    return bytes(out)


def _seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
    if AESGCM is not None:
        return AESGCM(key).encrypt(nonce, plaintext, aad or None)
    ct = _ctr_xor(key, nonce, plaintext)
    tag = _hmac.new(key, nonce + ct + aad, hashlib.sha256).digest()[:TAG_SIZE]
    return ct + tag


def _open(key: bytes, nonce: bytes, buf: bytes, aad: bytes) -> bytes:
    if AESGCM is not None:
        return AESGCM(key).decrypt(nonce, buf, aad or None)
    if len(buf) < TAG_SIZE:
        raise KeyringError("ciphertext shorter than the tag")
    ct, tag = buf[:-TAG_SIZE], buf[-TAG_SIZE:]
    want = _hmac.new(key, nonce + ct + aad,
                     hashlib.sha256).digest()[:TAG_SIZE]
    if not _hmac.compare_digest(tag, want):
        raise KeyringError("authentication tag mismatch")
    return _ctr_xor(key, nonce, ct)


def key_digest(key: bytes) -> str:
    """Loggable, non-secret identity of a key (forensics/invariants)."""
    return hashlib.sha256(key).hexdigest()[:12]


class SecretKeyring:
    def __init__(self, primary: bytes, keys: Optional[List[bytes]] = None):
        _check_key(primary)
        self._lock = threading.Lock()
        self._primary = primary
        self._keys: List[bytes] = [primary]
        for k in keys or []:
            if k != primary:
                _check_key(k)
                self._keys.append(k)

    # key management --------------------------------------------------------

    def primary_key(self) -> bytes:
        return self._primary

    def keys(self) -> List[bytes]:
        with self._lock:
            return list(self._keys)

    def install(self, key: bytes) -> None:
        _check_key(key)
        with self._lock:
            if key not in self._keys:
                self._keys.append(key)

    def use_key(self, key: bytes) -> None:
        with self._lock:
            if key not in self._keys:
                raise KeyringError("cannot use a key that is not installed")
            self._primary = key

    def remove(self, key: bytes) -> None:
        with self._lock:
            if key == self._primary:
                raise KeyringError("cannot remove the primary key")
            if key in self._keys:
                self._keys.remove(key)

    def digest(self) -> dict:
        """Non-secret keyring identity: primary digest + sorted key
        digests.  The keyring-divergence invariant compares these across
        live nodes, and red-run black boxes carry them for forensics."""
        with self._lock:
            return {"primary": key_digest(self._primary),
                    "keys": sorted(key_digest(k) for k in self._keys)}

    # crypto ----------------------------------------------------------------

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce = os.urandom(NONCE_SIZE)
        with self._lock:
            primary = self._primary
        ct = _seal(primary, nonce, plaintext, aad)
        metrics.incr("serf.keyring.encrypt")
        return bytes([ENCRYPTION_VERSION]) + nonce + ct

    def decrypt(self, buf: bytes, aad: bytes = b"") -> bytes:
        if len(buf) < 1 + NONCE_SIZE + TAG_SIZE \
                or buf[0] != ENCRYPTION_VERSION:
            raise KeyringError("malformed encrypted payload")
        nonce, ct = buf[1 : 1 + NONCE_SIZE], buf[1 + NONCE_SIZE :]
        # primary first (the overwhelmingly common case), then the
        # secondaries in install order — mid-rotation, a peer may still
        # encrypt with a key we have merely installed
        with self._lock:
            order = [self._primary] + [k for k in self._keys
                                       if k != self._primary]
        for i, key in enumerate(order):
            try:
                pt = _open(key, nonce, ct, aad)
            except Exception:
                continue
            if i:
                metrics.incr("serf.keyring.decrypt_fallback")
            return pt
        metrics.incr("serf.keyring.decrypt_fail")
        raise KeyringError("no installed key decrypts this payload")

    # persistence (reference writes keyring file mode 0600, base.rs:399-434)

    def save(self, path: str) -> None:
        # primary first, so load() restores the rotation state
        keys = [self._primary] + [k for k in self.keys() if k != self._primary]
        data = json.dumps([b64encode(k).decode() for k in keys])
        # atomic write-tmp-fsync-rename: a process
        # killed mid-save must leave the OLD keyring intact, never a
        # torn file a restart then fails to decrypt the cluster with
        from serf_tpu_torch.utils.files import atomic_write_text
        atomic_write_text(path, data, mode=0o600)

    @classmethod
    def load(cls, path: str) -> "SecretKeyring":
        try:
            with open(path) as f:
                keys = [b64decode(s) for s in json.load(f)]
        except (ValueError, binascii.Error) as e:
            # a torn/corrupt file fails closed with a keyring error, not
            # a JSON traceback (the atomic save makes this unreachable
            # for our own writes; it guards hand-edited/foreign files)
            raise KeyringError(f"keyring file {path} is unreadable: {e}")
        if not keys:
            raise KeyringError(f"keyring file {path} is empty")
        return cls(keys[0], keys[1:])


def _check_key(key: bytes) -> None:
    if len(key) not in KEY_SIZES:
        raise KeyringError(f"key must be 16/24/32 bytes, got {len(key)}")
