"""Build and load the port's CUDA kernels (``scda_tpu_torch/csrc/*.cu``).

At first use nvcc compiles every source at once, one process per file,
and links the objects into one shared library with a plain C interface,
which ctypes loads.  The file name embeds a hash of
the sources and flags (``_build/libscda_kernels-<hash>.so``), so a stale
binary is never loaded after a source change; the build writes a temp
file and renames it, so concurrent first uses race safely (the scheme of
``scda_tpu_torch/native/__init__.py``).  ``_build/`` is git-ignored.

A failed build raises: unlike ``scda_tpu_torch.native`` there is no fallback,
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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

    Every ``.cu`` compiles in its own nvcc process, all started together;
    one more links them.  Returns the library path.  nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel) is
    kept beside it as ``.log``.
    """
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cu = [p for p in sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{i}.o" for i in range(len(cu))]
    nvcc = _nvcc()
    procs = []
    try:
        for src, obj in zip(cu, objs):
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode} "
                                   f"on {os.path.basename(src)}:\n{out}")
            logs.append(f"== {os.path.basename(src)}\n{out}")
        link = [nvcc, "-shared", "-o", tmp, *objs]
        r = subprocess.run(link, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                               f"{' '.join(link)}\n{r.stdout}\n{r.stderr}")
        with open(path + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(tmp, path)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for leftover in [tmp, *objs]:
            if os.path.exists(leftover):
                os.unlink(leftover)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
            _lib.scda_cuda_error_string.argtypes = [ctypes.c_int]
            _lib.scda_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` with its argument and result types
    declared (a CUDA error code by default).

    Pointers and the stream must be ``ctypes.c_void_p``: an undeclared
    Python int is passed as a 32-bit int and cuts the pointer.
    """
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(lib(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().scda_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def refuse_grad(name: str, tensors, hint: str) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad.  A
    launch through ctypes is invisible to autograd, so the wrapper's
    output would carry no gradient, silently.  ``hint`` says what to do
    instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this wrapper launches a "
            f"CUDA kernel outside autograd and would return a detached "
            f"tensor; {hint}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
