"""The tracer kernel's body (csrc/tracer_body.cuh), built for the host CPU
by g++ (tools/host_trace.py) and run one ray after another through the
instance the card would launch (the read-only path, T = false), against
the plain tracer of ops/tracer_core.py.

Fast mode: the 4-page sector maze at 48x27 from its path camera and from
the camera facing a cross-page portal, and seeded rays of the fuzz world
(scene.fuzz_rays: rotated portals, ramps, fog, 2-high cells, six spheres)
at reflect 2 and 6, through the rendering instance and the measurement
instances a knob selects.  The host build's rsqrtf, sqrtf, sinf, cosf
and expf are the C library's, not torch's, so the plain tracer takes the
host's (host_trace.host_math) and fb, zbuf and the profile's per-wave
step counts are held bit for bit: every other operation is IEEE on both
sides (torch's CPU rsqrt and sqrt miss the correctly rounded result by
an ulp on some inputs, so torch's own functions would move some zbuf
words).  Parity mode calls no math library and is held as it is, on the
same fuzz rays."""

from __future__ import annotations

import pytest

from pwnfps_tpu_torch import scene as S
from pwnfps_tpu_torch.render.frame import frame_rays
from pwnfps_tpu_torch.tools import host_trace as ht

N_FUZZ = 300


@pytest.fixture(scope="module")
def lib():
    return ht.load()


def _maze(view: str):
    sc = S.maze_scene(48, 27, "cpu", view=view)
    origin, rayb, rdx, rdy, sec = sc.frame_args(0)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, "cpu")
    return sc.tworld, sc.cfg, ifrom, rays, seeds, sec, sc.cfg.cam_page


def _fuzz(reflect: int, parity: bool = False):
    wt, cfg, ifrom, rays, seeds = S.fuzz_rays(N_FUZZ, "cpu", seed=reflect,
                                              reflect=reflect, parity=parity)
    return wt, cfg, ifrom, rays, seeds, ht.SEC, 0


def _exact(r: dict, profile: bool) -> None:
    assert r["fb"] == 1.0 and r["zbuf"] == 1.0, r
    assert (r["tstep"] == 1.0) if profile else r["tstep"] is None, r


@pytest.mark.parametrize("knobs", ["none", "profile", "unpacked", "nowater",
                                   "fire1", "fetch2x", "pad64"])
@pytest.mark.parametrize("view", ["path", "portal"])
def test_fast_maze_equals_plain(lib, view, knobs):
    r = ht.run(lib, "", knobs, case=_maze(view))
    _exact(r, knobs == "profile")


@pytest.mark.parametrize("knobs", ["none", "profile", "fire1", "sel64",
                                   "profile_nowater_pad64"])
@pytest.mark.parametrize("reflect", [2, 6])
def test_fast_fuzz_rays_equal_plain(lib, reflect, knobs):
    r = ht.run(lib, "", knobs, case=_fuzz(reflect))
    _exact(r, "profile" in knobs)


@pytest.mark.parametrize("knobs", ["none", "profile"])
def test_parity_fuzz_rays_equal_plain(lib, knobs):
    r = ht.run(lib, "", knobs, case=_fuzz(2, parity=True))
    _exact(r, knobs == "profile")
