"""Build ``bbdm_tpu_torch/csrc/*.cu`` with nvcc on first use and load it with ctypes.

The counterpart of ``bbdm_tpu/native/build.py``: one shared library with a
plain C interface (no PyTorch headers, so nvcc takes seconds), compiled for
sm_90a into ``bbdm_tpu_torch/_build/`` under a name keyed by the sources'
hash. Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every entry returns the cudaError_t of its launch as int
_SIGNATURES = {
    # x, kp, bias, out, N, ci, co, h, w, stream
    "subpixel_upconv_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, BH, T, D, stream
    "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def build() -> str:
    """Compile the sources if no library for their hash exists; return its path."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"bbdm_kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bbdm_error_string.argtypes = [ctypes.c_int]
            lib.bbdm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a launch error."""
    if code != 0:
        msg = library().bbdm_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({code})")
