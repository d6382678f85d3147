"""Build harness for the CUDA kernels under csrc/.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes: no PyTorch headers, so a build
takes seconds.  The library lands in `_build/` beside this file (listed
in .gitignore), named by a hash of the source and the flags, so a
changed source or flag rebuilds and an unchanged one is reused.  Builds
happen at first use, from the sources in this checkout only.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# --fmad=false: every a*b+c rounds twice, as on the TPU and in eager
# torch.  Never --use_fast_math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
# per kernel library: seconds its build took in this process (0.0 when
# it was already built) and the ptxas report (registers, spills)
BUILD_SECONDS: dict[str, float] = {}
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if path is None and os.path.exists(home):
        path = home
    if path is None:
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: "
                           "the CUDA kernels cannot be built")
    return path


def _key(src: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists;
    returns the library path."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}-{_key(src)}.so")
    log = so[:-3] + ".log"
    if os.path.exists(so):
        BUILD_SECONDS.setdefault(name, 0.0)
        if os.path.exists(log):
            with open(log) as f:
                PTXAS_LOG[name] = f.read()
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent builders of the
    # same key never see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    PTXAS_LOG[name] = res.stderr
    with open(log, "w") as f:
        f.write(res.stderr)
    return so


def load(name: str, sigs: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu.  sigs maps each C
    function to its ctypes argtypes; every function returns int (its
    cudaGetLastError())."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, argtypes in sigs.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
