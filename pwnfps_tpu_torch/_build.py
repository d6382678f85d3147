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
# torch; / and sqrtf IEEE-rounded and subnormals kept (the defaults,
# stated because parity mode depends on them).  Never --use_fast_math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "--prec-div=true", "--prec-sqrt=true",
              "--ftz=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

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


def _paths(name: str) -> tuple[str, str]:
    src = os.path.join(SRC_DIR, f"{name}.cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{_key(src)}.so")


def build_all(names) -> dict[str, str]:
    """Compile each csrc/<name>.cu that has no up-to-date library, one
    nvcc process per source, all started together; returns each
    library's path."""
    jobs, out = {}, {}
    nvcc = None
    for name in names:
        src, so = _paths(name)
        out[name] = so
        if os.path.exists(so):
            BUILD_SECONDS.setdefault(name, 0.0)
            log = so[:-3] + ".log"
            if os.path.exists(log):
                with open(log) as f:
                    PTXAS_LOG[name] = f.read()
            continue
        nvcc = nvcc or nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a private name, then rename: concurrent builders of
        # the same key never see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, src, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, src, so, t0) in jobs.items():
        try:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{stdout}\n{stderr}")
                continue
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = stderr
        with open(so[:-3] + ".log", "w") as f:
            f.write(stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists;
    returns the library path."""
    return build_all([name])[name]


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
