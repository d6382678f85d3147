"""ctypes bindings for the native C++ host runtime (native/presenter.cpp).
Copied from pwnfps_tpu/host/native.py, building elsewhere.

The repository's native/presenter.cpp is built where it lies, with g++,
on first use, into this package's `_build/` (listed in .gitignore) under
a name keyed by the source's hash, so that this package never shares a
library with the JAX package's native/build/.  Every entry point has a
numpy path with the same results, which runs where no g++ exists:
`available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     ".."))
_SRC = os.path.join(_REPO, "native", "presenter.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libpwnfps_host-{key}.so")


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            # build to a private name, then rename: concurrent builders
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None               # no g++ or no loadable library: numpy
    lib.fb_to_rgb_upscaled.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.write_ppm.restype = ctypes.c_int
    lib.write_ppm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    lib.prepare_render.restype = ctypes.c_int
    lib.prepare_render.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library runs; False when the numpy paths do."""
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def fb_to_rgb_upscaled(fb: np.ndarray, scale: int) -> np.ndarray:
    """uint32 BGRA [h,w] -> uint8 RGB [h*s, w*s, 3] (native or numpy)."""
    fb = np.ascontiguousarray(fb, np.uint32)
    h, w = fb.shape
    lib = _load()
    if lib is None:
        px = fb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0]]
        return np.repeat(np.repeat(px, scale, 0), scale, 1)
    out = np.empty((h * scale, w * scale, 3), np.uint8)
    lib.fb_to_rgb_upscaled(_ptr(fb, ctypes.c_uint32), h, w, scale,
                           _ptr(out, ctypes.c_uint8))
    return out


def write_ppm(path: str, rgb: np.ndarray) -> None:
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    lib = _load()
    if lib is None:
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(rgb.tobytes())
        return
    rc = lib.write_ppm(path.encode(), _ptr(rgb, ctypes.c_uint8), h, w)
    if rc != 0:
        raise OSError(f"write_ppm failed ({rc}) for {path}")


def prepare_render_native(pool, k_bucket: int):
    """Native level_prepare_render: (buckets, counts, masks, n_live) or
    None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buckets = np.empty((64, 64, k_bucket), np.int32)
    counts = np.empty((64, 64), np.int32)
    masks = np.empty((64, 64), np.int32)
    pos = np.ascontiguousarray(pool.pos[:pool.objs_num])
    n = lib.prepare_render(
        _ptr(pool.typ, ctypes.c_int8), _ptr(pool.r, ctypes.c_float),
        _ptr(np.ascontiguousarray(pos[:, 0]), ctypes.c_float),
        _ptr(np.ascontiguousarray(pos[:, 1]), ctypes.c_float),
        _ptr(np.ascontiguousarray(pos[:, 2]), ctypes.c_float),
        pool.objs_num, k_bucket,
        _ptr(buckets, ctypes.c_int32), _ptr(counts, ctypes.c_int32),
        _ptr(masks, ctypes.c_int32))
    if n < 0:
        raise ValueError("prepare_render: bucket overflow or bbox out of "
                         "grid (the reference would corrupt memory here)")
    return buckets, counts, masks, n
