"""The blur kernel's body (csrc/blur.cu), built for the host CPU by g++
(tools/host_blur.py) and run one tile after another, against the plain
passes of pwnfps_tpu_torch/ops/blur.py, bit for bit.

The depths mix tiles whose window the kernel stages with tiles over its
cap, beside NaN depths (whose taps fall outside the window), +-inf and
+-1e30; the shapes take both staging paths (16-byte rows where w % 4 ==
0, 4-byte ones where w % 4 == 3), frames whose height is no multiple of
the tile's, stacked frames, and bands whose pad rows past the frame clip
their taps to the buffer."""

import pytest
import torch

from pwnfps_tpu_torch.ops import blur
from pwnfps_tpu_torch.tools import host_blur as hb


def _paths(st: dict) -> None:
    """Both kinds of tile and every tap path were taken."""
    assert st["staged"] > 0 and st["unstaged"] > 0, st
    assert st["window_taps"] > st["edge_taps"] > 0, st
    assert st["global_taps"] > 0, st


@pytest.mark.parametrize("h,w,nf,seed", [(150, 203, 1, 1), (40, 132, 3, 2),
                                         (120, 160, 1, 3)])
def test_host_frame_blur_equals_plain(h, w, nf, seed):
    fb, z = hb.reach_frame(h, w, seed, nf)
    want = blur.dof_blur_plain(fb, z, 1, h)
    total = dict.fromkeys(hb.STATS, 0)
    for th in hb.THS:
        for tw in hb.TWS:
            got, st = hb.host_blur(fb, z, h, th, tw)
            assert torch.equal(got, want), (tw, th)
            total = {k: total[k] + st[k] for k in hb.STATS}
    _paths(total)


# (75, 132, 1, 24, 2, 16): the band at y0 = 48 taps frame row 74 from its
# real rows, one row past its buffer: a tap on the window's far edge that
# must clip to the buffer's last word
@pytest.mark.parametrize("h,w,cl,rows,halo", [(100, 131, 2, 24, 20),
                                              (96, 128, 1, 40, 24),
                                              (200, 128, 1, 136, 48),
                                              (75, 132, 1, 24, 2)])
def test_host_band_blur_equals_plain(h, w, cl, rows, halo):
    fb, z = hb.reach_frame(h, w, h + w, cl)
    fb, z = fb.view(cl, h, w), z.view(cl, h, w)
    total = dict.fromkeys(hb.STATS, 0)
    for fp, zb, y0 in hb.band_inputs(fb, z, rows, halo, -(-h // rows)):
        want = blur.dof_blur_band_plain(fp, zb, y0, h)
        for th in hb.THS:
            for tw in hb.TWS:
                got, st = hb.host_blur_band(fp, zb, y0, h, th, tw)
                assert torch.equal(got, want), (y0, tw, th)
                total = {k: total[k] + st[k] for k in hb.STATS}
    _paths(total)


def test_host_blur_refuses_a_tile_the_kernel_has_not():
    fb, z = hb.reach_frame(16, 16, 0)
    with pytest.raises(ValueError):
        hb.host_blur(fb, z, 16, 64)
    with pytest.raises(ValueError):
        hb.host_blur(fb, z, 16, 32, 16)
