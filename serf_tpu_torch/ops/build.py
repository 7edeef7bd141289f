"""Build and bind the CUDA kernels.

``nvcc`` compiles ``csrc/round_kernels.cu`` (a plain C interface, no
PyTorch headers — seconds, not minutes) into a shared library under
``build/serf_tpu_torch/`` at the repository root, named by a digest of
the source and flags so an edited source is never served stale.  The
build happens at first use; :func:`load` returns the bound library.
Pointers and the stream are passed as ``c_void_p`` (a plain ``int``
would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "round_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "serf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "serf_select_packets": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
    "serf_merge_incoming": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                            _P),
    "serf_fused_select_cached": (_P, _P, _P, _P, _I64, _I, _P),
    "serf_fused_merge": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                         _I, _I, _I, _P),
    "serf_fused_flush": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                         _I, _P),
}

_LIB: list = []


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libround_kernels-{digest[:16]}.so"


def build(ptxas_verbose: bool = False) -> tuple:
    """Compile the kernels if the library for this source is missing.
    Returns ``(path, compiler output)``; raises with the compiler's
    output when ``nvcc`` fails."""
    out = library_path()
    if out.exists() and not ptxas_verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The bound kernel library (built at first use)."""
    if not _LIB:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.serf_error_string.argtypes = (ctypes.c_int,)
        lib.serf_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().serf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
