"""The launch route every kernel wrapper of the port takes.

A kernel's C entry point (csrc/*.cu, built by `_build`) is an `Entry`:
its library is built and the function resolved once, at the first call,
with its ctypes argument types.  A call passes the device index of the
tensors it launches on; the route then

  * takes that device's current stream as a raw handle
    (`torch._C._cuda_getCurrentRawStream`, as Triton's launcher does),
    so a side stream and a CUDA graph's capture stream are honoured and
    no Stream object is built;
  * makes the device current only when it is not already (a
    `torch.cuda.device` block swaps it twice on every call);
  * raises on a nonzero return, the entry's cudaGetLastError().

The stream handle goes last, after the entry's own arguments.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# absent from a CPU-only torch, which launches nothing
_get_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Entry:
    """C function `fn` of csrc/<lib>.cu taking `argtypes` and then a
    stream, returning a CUDA error code."""

    __slots__ = ("lib", "fn", "argtypes", "_f")

    def __init__(self, lib: str, fn: str, argtypes):
        self.lib, self.fn, self.argtypes = lib, fn, list(argtypes)
        self._f = None

    def resolve(self):
        """The ctypes function, building its library first if needed."""
        if self._f is None:
            f = getattr(ctypes.CDLL(_build.build(self.lib)), self.fn)
            f.argtypes = self.argtypes + [ctypes.c_void_p]
            f.restype = ctypes.c_int
            self._f = f
        return self._f

    def __call__(self, index: int, *args) -> None:
        """Launch on device `index`'s current stream, or raise."""
        self.on(index, _raw_stream(index), *args)

    def on(self, index: int, stream: int, *args) -> None:
        """Launch on `stream` of device `index` (see stream()), or
        raise."""
        f = self._f or self.resolve()
        if _get_device() == index:
            err = f(*args, stream)
        else:
            with torch.cuda.device(index):
                err = f(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.fn} launch failed: CUDA error {err}")


def stream(index: int) -> int:
    """The raw handle of device `index`'s current stream."""
    return _raw_stream(index)
