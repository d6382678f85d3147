"""The ray kernel's body (csrc/rays.cu), built for the host CPU by g++
(tools/host_rays.py) and run one group of pixels after another, against
the plain path of pwnfps_tpu_torch/render/frame.py (gen_rays,
pixel_seeds and the origin broadcast), bit for bit.

Fast mode and parity mode's serial adds, on poses of the flagship
scene's camera path, at widths that are a multiple of neither 32 nor 8
(a ragged parity tile, a ragged group of 4), 1x1, and widths a multiple
of 4, each into planes on a 16-byte boundary (16-byte stores) and one
word past it (4-byte stores)."""

import dataclasses

import pytest

from pwnfps_tpu_torch import scene as S
from pwnfps_tpu_torch.tools import host_rays as hr


@pytest.fixture(scope="module")
def lib():
    return hr.lib()


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("w,h", hr.SHAPES)
def test_host_rays_equal_plain(lib, w, h, parity):
    sc = S.flagship_scene(w, h, "cpu")
    cfg = dataclasses.replace(sc.cfg, parity=parity)
    for k in hr.FRAMES:
        for offset in (0, 1):
            assert hr.equal(cfg, sc.frame_args(k)[:4], offset), (k, offset)


def test_host_rays_refuse_a_bad_frame(lib):
    sc = S.flagship_scene(4, 3, "cpu")
    args = sc.frame_args(0)[:4]
    for w, h in ((0, 3), (4, 0)):
        with pytest.raises(ValueError):
            hr.host_rays(dataclasses.replace(sc.cfg, width=w, height=h),
                         *args)
