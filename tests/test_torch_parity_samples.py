"""Pixel-exact path tracing in the port: parity mode with samples > 1
(K1's parity-samples instance; on the CPU its plain tracer), against the
JAX package's scalar specification `ops/tracer_ref.ScalarTracer(
pinned=True)`.

With cfg.samples > 1 the parity march of the primary wave runs once and
each sample k runs its parity shade-and-bounce chain from it with the
seed stream seed + k*0x9E3779B9 (uint32); the colour is the chains'
sum in sample order times f32(1/samples), packed, and the distance is
the primary wave's (pwnfps_tpu/ops/tracer_core.py:1804-1817 under
`_parity_math`).  The scalar spec traces one ray with one seed and
returns its unpacked colour (tracer_ref.py:137-147), so a ray's
reference is the same sum over per-sample `trace` calls.  Checked:

  * 32 rays of `parity_scene` at reflect 2, samples 2 and 4, fb and
    dist bit-equal to that reference (the scalar spec's depth is its
    fixed REFLECT = 2, tracer_ref.py:156, so it cannot check deeper
    chains); samples 2's chains are the first two of samples 4's, so
    each ray costs four scalar traces;
  * a 16x12 `render_accumulated(parity=True)` frame, samples 2 with one
    DoF pass, bit-equal to the mean of the port's own per-sample parity
    traces, packed and blurred (torch only).  Config #5's depth in
    parity mode, reflect 6 and samples 4, is the same check on the 8x4
    parity ptrace frame: tests/test_torch_samples.py::
    test_samples_in_parity_mode_raise (named for the refusal it once
    asserted).
"""

import numpy as np
import pytest
import torch

from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.world.levelc import compile_level as ref_compile
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.tracer_core import WEYL
from pwnfps_tpu_torch.scene import CREATURE, parity_scene

from .test_torch_parity import (_bits, _demo_rays, _demo_text,
                                _ref_creature_pool)
from .test_torch_samples import _torch_rays, accumulated_equals_mean

SEC = np.float32(1.75)
N = 32
SAMPLES = (2, 4)


def _pack(cols: np.ndarray) -> np.ndarray:
    """util.h:48-59's BGRA8 pack of [n, 4] colours (round half to even,
    clamp, >= 2^31 or NaN -> 0), as tests/test_torch_parity.py packs."""
    v = cols * np.float32(255.0)
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(v), 0.0, 255.0)
        q[(v >= np.float32(2 ** 31)) | np.isnan(v)] = 0
    q = q.astype(np.uint32)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)


@pytest.fixture(scope="module")
def scalar_chains():
    """The rays, and each ray's scalar-spec colour for sample streams
    k = 0 .. max(SAMPLES)-1 and its distance (the same for every k: the
    primary wave draws no random number)."""
    froms, dirs, seeds = _demo_rays(N, seed0=41)
    sw = ScalarWorld(ref_compile(_demo_text()),
                     _ref_creature_pool(len(CREATURE)).prepare_render(),
                     RefTables.load())
    cols = np.zeros((max(SAMPLES), N, 4), np.float32)
    dists = np.zeros(N, np.float32)
    for k in range(max(SAMPLES)):
        sk = seeds + np.uint32((k * WEYL) & 0xFFFFFFFF)
        for i in range(N):
            tr = ScalarTracer(sw, sec_current=SEC, pinned=True)
            cols[k, i], d, _ = tr.trace(froms[i], dirs[i], int(sk[i]))
            assert k == 0 or _bits(d) == _bits(dists[i])
            dists[i] = d
    return dict(rays=(froms[:, :3], dirs[:, :3], seeds), cols=cols,
                dists=dists)


@pytest.mark.parametrize("samples", SAMPLES)
def test_parity_samples_match_scalar_spec(scalar_chains, samples):
    sc = parity_scene(8, 4, "cpu", samples=samples)
    assert sc.cfg.parity and sc.cfg.reflect == 2
    before = (tracer.LAUNCHES_PARITY, tracer.LAUNCHES_PARITY_SAMPLES)
    fb, dist = tracer.trace_wave(sc.tworld, sc.cfg,
                                 *_torch_rays(*scalar_chains["rays"]), SEC,
                                 pack=True)
    assert (tracer.LAUNCHES_PARITY,
            tracer.LAUNCHES_PARITY_SAMPLES) == before   # CPU: plain
    acc = scalar_chains["cols"][0]
    for k in range(1, samples):
        acc = acc + scalar_chains["cols"][k]
    want = _pack(acc * np.float32(1.0 / samples))
    got = fb.numpy().view(np.uint32)
    bad = np.flatnonzero(got != want)
    assert not bad.size, (f"{bad.size} of {N} rays differ, first "
                          f"{bad[:4]}: {got[bad[:4]]} vs {want[bad[:4]]}")
    assert np.array_equal(_bits(dist.numpy()),
                          _bits(scalar_chains["dists"]))
    # the chains differ, so the mean is not sample 0's colour
    assert not np.array_equal(want, _pack(scalar_chains["cols"][0]))


def test_accumulated_parity_frame_is_mean_of_samples():
    sc = parity_scene(16, 12, "cpu")
    assert sc.cfg.parity and sc.cfg.postproc_blur == 1
    before = (tracer.LAUNCHES_PARITY, tracer.LAUNCHES_PARITY_SAMPLES)
    fb = accumulated_equals_mean(sc, 1, 2)
    assert (tracer.LAUNCHES_PARITY,
            tracer.LAUNCHES_PARITY_SAMPLES) == before   # CPU: plain
    assert torch.unique(fb).numel() > 50        # not a flat frame
