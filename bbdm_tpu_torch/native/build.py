"""Build ``bbdm_tpu_torch/native/*.cpp`` with g++ on first use and load it with ctypes.

The counterpart of ``bbdm_tpu/native/build.py``: one shared library with a
plain C interface, compiled into ``bbdm_tpu_torch/_build/`` under a name keyed
by the hash of the sources, the flags and ``g++ --version``. Processes that
build at once take turns on an ``fcntl`` lock in that directory; each writes
its own temporary file and renames it into place. There is no fallback: a missing
compiler or a failed build raises ``RuntimeError`` with the compiler's output.
``$CXX`` names another compiler.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import threading

NATIVE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE), "_build")
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signatures: every entry but gif_lzw returns 0, or a non-zero code
_SIGNATURES = {
    # data, size, rows, row bytes, bytes per pixel, out [rows, row bytes]
    "png_unfilter": [_P, _L, _I, _I, _I, _P],
    # uint8 [h, w, c] (c 1..4), h, w, c, out float32 [oh, ow, 3], oh, ow, flip, to_normal
    "preprocess_image": [_P, _I, _I, _I, _P, _I, _I, _I, _I],
    # data, size, out [height, width, components], err, err size
    "jpeg_info": [_P, _L, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, _I],
    # data, size, out uint8 [height, width, 3], err, err size
    "jpeg_decode": [_P, _L, _P, ctypes.c_char_p, _I],
    # data, size, out [canvas height, canvas width], err, err size
    "webp_info": [_P, _L, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, _I],
    # data, size, out uint8 [height, width, 3], err, err size
    "webp_decode": [_P, _L, _P, ctypes.c_char_p, _I],
    # uint8 indices, count, out, out capacity -> length of the LZW stream, or -1
    "gif_lzw": [_P, _L, _P, _L],
}

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _version(cxx: str) -> str:
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"the host image library needs a C++ compiler: {cxx}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed (rc {proc.returncode}): {proc.stderr}")
    return proc.stdout


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(NATIVE, "*.cpp")))


def library_path(cxx: str) -> str:
    """``_build/fastimage-<hash>.so``: the hash of the sources, the flags and the
    compiler's version."""
    h = hashlib.sha256()
    for s in sources():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_version(cxx).encode())
    return os.path.join(BUILD_DIR, f"fastimage-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library for their hash exists; return its path."""
    cxx = compiler()
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "fastimage.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building the same file
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            proc = subprocess.run([cxx, *FLAGS, *sources(), "-o", tmp],
                                  capture_output=True, text=True, timeout=600)
        except OSError as e:
            raise RuntimeError(f"the host image library: {cxx} did not run: {e}") from None
        if proc.returncode != 0 or not os.path.exists(tmp):
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"the host image library did not build ({cxx}, rc "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded host image library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64 if name == "gif_lzw" else ctypes.c_int
            _lib = lib
        return _lib
