"""The yardstick's fixed numbers: one H100's peaks and the work a frame needs.

Copied from chip_smoke.py (HBM_BPS, PEAK_OPS, OPS_FAST, OPS_PARITY,
TRACE_BYTES_PER_RAY, BLUR_BYTES_PER_PX, trace_bound_ms and the blur's
bound at :682), so that the benchmark's roofline does not move when the
program's own smoke script does.

The tracer's operations per unit of work were counted from
csrc/tracer_body.cuh: FP32 adds, multiplies and min/max (compares,
selects and loads are not counted).  The units are the plain tracer's
counts (reference/ops/tracer_core.run_segment and sphere_all): a DDA
step of a live lane, a traced segment (init, shading, bounce and
unwind), a hoisted sphere test in fast mode (entry point, offset, two
dot products: 27), a near test among them (the two roots and the 7
operations around them: 21), a parity bucket slot test, and a slot hit
(the IEEE root, quotient and root and the 4 adds and max around them:
29, from their sm_90a SASS, an FFMA counted as two).
"""

from __future__ import annotations

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_OPS = 67e12

OPS_FAST = {"steps": 26, "segments": 140, "sphere_tests": 27,
            "sphere_near": 21}
OPS_PARITY = {"steps": 15, "segments": 200, "slot_tests": 15,
              "slot_hits": 29}
# bytes a trace must move: 6 f32 ray components and an i32 seed in, an
# i32 BGRA word and an f32 distance out
TRACE_BYTES_PER_RAY = 36
# the blur: fb and zbuf in, fb out, per pixel; its jump table, 64 B a
# column, once a pass
BLUR_BYTES_PER_PX = 12
BLUR_TABLE_BYTES_PER_COL = 64


def trace_bound_ms(counts: dict, parity: bool, n_rays: int):
    """(bound ms, "operations" or "bytes", operations) of a trace whose
    plain run counted `counts`: the larger of its operations over
    PEAK_OPS and its bytes over HBM_BPS."""
    ops = OPS_PARITY if parity else OPS_FAST
    n_ops = sum(ops[k] * counts.get(k, 0) for k in ops)
    t_ops = n_ops / PEAK_OPS * 1e3
    t_bytes = TRACE_BYTES_PER_RAY * n_rays / HBM_BPS * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", n_ops)


def blur_bound_ms(width: int, height: int) -> float:
    """The least time of one DoF pass over a width x height frame: its
    bytes over HBM_BPS."""
    return ((BLUR_BYTES_PER_PX * width * height
             + BLUR_TABLE_BYTES_PER_COL * width) / HBM_BPS * 1e3)
