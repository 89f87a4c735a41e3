"""Build and load the port's CUDA kernels (``scda_tpu_torch/csrc/*.cu``).

At first use nvcc compiles every source into one shared library with a
plain C interface, and ctypes loads it.  The file name embeds a hash of
the sources and flags (``_build/libscda_kernels-<hash>.so``), so a stale
binary is never loaded after a source change; the build writes a temp
file and renames it, so concurrent first uses race safely (the scheme of
``scda_tpu/native/__init__.py``).  ``_build/`` is git-ignored.

A failed build raises: unlike ``scda_tpu.native`` there is no fallback,
because a CUDA tensor has no other path.  ``torch.utils.cpp_extension``
is not used: a source that includes PyTorch's headers takes minutes to
compile, these take seconds.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libscda_kernels-{h.hexdigest()[:12]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of scda_tpu_torch "
                           "need the CUDA toolkit to build")
    return found


def build() -> str:
    """Compile the kernels unless a library for these sources exists.

    Returns the library path.  nvcc's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``.
    """
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cu = [p for p in sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {r.returncode}:\n{' '.join(cmd)}\n"
                f"{r.stdout}\n{r.stderr}")
        with open(path + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
            _lib.scda_cuda_error_string.argtypes = [ctypes.c_int]
            _lib.scda_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list):
    """The C entry point ``name`` with its argument types declared.

    Pointers and the stream must be ``ctypes.c_void_p``: an undeclared
    Python int is passed as a 32-bit int and cuts the pointer.
    """
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(lib(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().scda_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
