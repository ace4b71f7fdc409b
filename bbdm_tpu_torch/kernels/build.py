"""Build ``bbdm_tpu_torch/csrc/*.cu`` with nvcc on first use and load it with ctypes.

The counterpart of ``bbdm_tpu/native/build.py``: one shared library with a
plain C interface (no PyTorch headers, so nvcc takes seconds), compiled for
sm_90a into ``bbdm_tpu_torch/_build/`` under a name keyed by the hash of every
source and header in ``csrc/`` and the flags. Each ``.cu`` file compiles in its
own nvcc process, all started together, then one link. Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()`` (or
another ``cudaError_t``); :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every entry returns a cudaError_t as int
_SIGNATURES = {
    # x, w, b, film_scale, film_shift, out, plan (15 x uint64,
    # ops/group_norm.GroupNormPlan.c_values), clusters, dtype, film, film_f32,
    # film_stride, silu, eps, stream
    "group_norm_fwd": [_P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_uint64), _I, _I, _I, _I,
                       ctypes.c_int64, _I, ctypes.c_float, _P],
    # dtype, cs, smem_bytes, out: clusters resident at once
    "group_norm_resident_clusters": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    # x, kp, bias, out, plan (24 x uint64, ops/upsample_conv.UpconvPlan.c_values), stream
    "subpixel_upconv_bf16": [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_uint64), _P],
    # x, kp, bias, out, x_hi, x_lo, k_hi, k_lo, half0, N, ci, co, h, w, plan (24 x
    # uint64, UpconvPlan.c_values for 4-byte elements), stream
    "subpixel_upconv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_uint64), _P],
    # q, k, v, out, BH, Tq, Tk, D, Tqm, Tkm, Dm, smem_bytes, stream
    "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, qs, ks, vs, BH, Tq, Tk, D, Tqm, Tkm, Dm, smem_bytes, stream
    "flash_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
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


def source_hash() -> str:
    """Hash of every ``csrc/*.cu`` and ``csrc/*.cuh`` and the nvcc flags."""
    h = hashlib.sha256()
    for s in sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if no library for their hash exists; return its path.
    The compiler's output (ptxas registers and spills per kernel) and the build
    time go to the ``.log`` beside the library."""
    out = os.path.join(BUILD_DIR, f"bbdm_kernels-{source_hash()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    procs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {os.path.basename(src)} (rc {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(text)
    tmp = f"{out}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                               "-o", tmp, *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(link.stderr)
    for _, obj, _ in procs:
        if os.path.exists(obj):
            os.remove(obj)
    log.append(f"== build time {time.time() - t0:.1f} s")
    with open(out[:-3] + ".log", "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(t[-4000:] for t in failed))
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
