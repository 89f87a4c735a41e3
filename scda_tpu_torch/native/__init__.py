"""ctypes loader for the native host-side data-prep library.

Builds the shared library from prep.cc on first use.  The cache file name
embeds a content hash of prep.cc (``libscda_prep-<hash>.so``) so a stale
binary can never be loaded after a source change, and the build writes to
a temp file and atomically renames so concurrent first-use builds race
safely.  The library is never committed to git.  Exposes:

  * :func:`prep_image_native` — bilinear resize + mean-subtract + canvas
    paste + optional flip (the reference's cv2-based prep_im_for_blob hot
    path, ref lib/model/utils/blob.py:~40);
  * :func:`bbox_overlaps_native` — pairwise IoU for host-side eval
    (ref lib/model/utils/bbox.pyx).

``available()`` is False (and every call raises) when no C++ toolchain
exists or SCDA_NATIVE=0; callers fall back to the numpy implementations
in :mod:`scda_tpu_torch.data.pipeline` / :mod:`scda_tpu_torch.evals.voc_eval`, which
compute the *same* math (tests pin equality).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "prep.cc")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"libscda_prep-{digest}.so")


def _build(lib_path: str) -> bool:
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    cmds = [
        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp],
        # Fallback without OpenMP.
        ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
    ]
    try:
        for cmd in cmds:
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
                if r.returncode == 0:
                    os.replace(tmp, lib_path)
                    return True
            except (OSError, subprocess.TimeoutExpired):
                return False
        return False
    finally:
        # Both compiler attempts failed (or the success path already
        # os.replace'd): never leave an orphaned partial object behind.
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SCDA_NATIVE", "1") == "0":
            return None
        try:
            lib_path = _lib_path()
            if not os.path.exists(lib_path) and not _build(lib_path):
                return None
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.prep_image.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int,
        ]
        lib.prep_image.restype = None
        lib.prep_image_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int,
        ]
        lib.prep_image_u8.restype = None
        lib.bbox_overlaps.argtypes = [
            f32p, ctypes.c_int, f32p, ctypes.c_int, f32p,
        ]
        lib.bbox_overlaps.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def prep_image_native(
    img: np.ndarray,            # (H, W, 3) uint8 or float32 BGR
    canvas_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    mean: np.ndarray,           # (3,) float32
    flip: bool = False,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native prep library unavailable")
    if img.size == 0:
        raise ValueError("prep_image_native: empty image")
    if out_hw[0] > canvas_hw[0] or out_hw[1] > canvas_hw[1]:
        raise ValueError(
            f"prep_image_native: out_hw {tuple(out_hw)} exceeds canvas "
            f"{tuple(canvas_hw)} (the C++ kernel does not bounds-check)")
    mean = np.ascontiguousarray(mean, np.float32)
    canvas = np.empty((canvas_hw[0], canvas_hw[1], 3), np.float32)
    if img.dtype == np.uint8:
        img = np.ascontiguousarray(img)
        fn = lib.prep_image_u8
    else:
        img = np.ascontiguousarray(img, np.float32)
        fn = lib.prep_image
    fn(
        img, img.shape[0], img.shape[1],
        canvas, canvas_hw[0], canvas_hw[1],
        out_hw[0], out_hw[1], mean, int(flip),
    )
    return canvas


def bbox_overlaps_native(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native prep library unavailable")
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.empty((len(a), len(b)), np.float32)
    lib.bbox_overlaps(a, len(a), b, len(b), out)
    return out
