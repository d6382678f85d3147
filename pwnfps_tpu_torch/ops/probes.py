"""The probe kernels of the port's tools (pwnfps_tpu_torch/tools/).

`add_one` is o = x + 1 (the TPU kernel of tools/launch_probe.py, kern
:36-37), the unit the launch probe chains; `vpu_chains` is the chains
probe of tools/vpu_probe.py (make_kernel :47-77), which reads the FP32
and select issue rates.  Each has its plain torch version beside it,
`add_one_plain` and `vpu_chains_plain`; the entry points take it for CPU
tensors and launch the kernel of csrc/probes.cu for CUDA tensors, or
raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

# launches of each kernel since import (reset by callers that count); a
# launch recorded into a CUDA graph counts once, at its capture
LAUNCHES_ADD_ONE = 0
LAUNCHES_VPU = 0
# C entry points of csrc/probes.cu
_SIGS = {"pwnfps_add_one": [ctypes.c_void_p] * 2 + [ctypes.c_int]
         + [ctypes.c_void_p],
         "pwnfps_vpu_chains": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
         + [ctypes.c_float] * 2 + [ctypes.c_void_p]}

ROWS, LANES = 8, 128        # one plane (vpu_probe.py:34)
U = 32                      # chained updates a chain an iteration (:35)
OPS_PER_UPDATE = {"fma": 2, "sel": 3}
S_VALUES = (1, 4, 16)
# vpu_probe.py:50's constants, as f32
MUL = float(np.float32(0.9999))
ADD = float(np.float32(1e-7))


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 of a float32 tensor, as a new tensor."""
    global LAUNCHES_ADD_ONE
    if x.dtype != torch.float32:
        raise ValueError("add_one takes float32")
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.numel() >= 2 ** 31:
        raise ValueError("add_one takes a contiguous tensor of fewer than "
                         "2^31 elements")
    out = torch.empty_like(x)
    lib = _build.load("probes", _SIGS)
    with torch.cuda.device(x.device):
        err = lib.pwnfps_add_one(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_one launch failed: CUDA error {err}")
    LAUNCHES_ADD_ONE += 1
    return out


def _check_chains(a: torch.Tensor, variant: str, S: int, T: int,
                  blocks: int) -> None:
    if a.shape != (ROWS, LANES) or a.dtype != torch.float32:
        raise ValueError("a must be float32 [8, 128]")
    if variant not in OPS_PER_UPDATE or S not in S_VALUES or T < 0 \
            or blocks < 1:
        raise ValueError(f"variant {variant!r}, S={S}, T={T}, "
                         f"blocks={blocks}: want fma or sel, S in "
                         f"{S_VALUES}, T >= 0, blocks >= 1")


def vpu_chains_plain(a: torch.Tensor, variant: str, S: int, T: int,
                     blocks: int = 1) -> torch.Tensor:
    """The chains probe in eager torch, every update a torch op: T*U*S
    updates, so keep T small.  Returns [blocks, 8, 128], each block's
    plane equal."""
    _check_chains(a, variant, S, T, blocks)
    m = a * MUL + ADD
    accs = [a + float(s) for s in range(S)]
    for _ in range(T):
        for _u in range(U):
            for s in range(S):
                if variant == "fma":
                    accs[s] = accs[s] * m + a
                else:
                    accs[s] = torch.where(accs[s] > a, accs[s] * m, a)
    r = accs[0]
    for x in accs[1:]:
        r = r + x
    return r.expand(blocks, ROWS, LANES).clone()


def vpu_chains(a: torch.Tensor, variant: str, S: int, T: int,
               blocks: int = 1) -> torch.Tensor:
    """The chains probe on a float32 [8, 128] plane: `blocks` copies of
    it, each over S chains of T*32 `variant` updates.  Returns [blocks,
    8, 128]."""
    global LAUNCHES_VPU
    _check_chains(a, variant, S, T, blocks)
    if a.device.type == "cpu":
        return vpu_chains_plain(a, variant, S, T, blocks)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    keep = a.contiguous()
    out = torch.empty((blocks, ROWS, LANES), dtype=torch.float32,
                      device=a.device)
    lib = _build.load("probes", _SIGS)
    with torch.cuda.device(a.device):
        err = lib.pwnfps_vpu_chains(keep.data_ptr(), out.data_ptr(),
                                    int(variant == "sel"), S, T, blocks,
                                    MUL, ADD,
                                    torch.cuda.current_stream(
                                        a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vpu_chains launch failed: CUDA error {err}")
    LAUNCHES_VPU += 1
    return out


def chain_ops(variant: str, S: int, T: int, blocks: int = 1) -> int:
    """Element operations the chains probe does (its updates only)."""
    return blocks * ROWS * LANES * T * U * S * OPS_PER_UPDATE[variant]
