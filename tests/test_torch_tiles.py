"""The tracer kernel's warp tiles on the CPU.

`ops.tracer.warp_tiles` mirrors the kernel's map from a warp to its 32
rays (csrc/tracer_body.cuh tile_ray): 8x4-pixel tiles of a row-major
image, the last row and column of tiles ragged, or runs of 32 rays where
the width does not divide n.  The map must be a bijection between the
live lanes and the rays.  The occupancy tool groups a profile trace's
per-wave step counts by these tiles (`warp_tile`); its statistics on a
small plain profile trace must equal a restatement that walks the
image's 8x4 blocks directly."""

import numpy as np
import pytest

from pwnfps_tpu_torch.ops.tracer import warp_tiles
from pwnfps_tpu_torch.scene import flagship_scene, maze_scene
from pwnfps_tpu_torch.tools import occupancy


@pytest.mark.parametrize("n,width", [(1920 * 1080, 1920), (160 * 90, 160),
                                     (33 * 17, 33), (7 * 5, 7), (1, 1),
                                     (20, 20), (100, 7), (561, 34)])
def test_warp_tiles_are_a_bijection(n, width):
    tiles = warp_tiles(n, width)
    assert tiles.shape[1] == 32
    live = tiles[tiles >= 0]
    assert np.array_equal(np.sort(live), np.arange(n))
    assert (tiles >= 0).any(axis=1).all()       # no empty warp
    if n % width:                               # flat: 32 consecutive rays
        assert np.array_equal(live, np.arange(n))
    else:                                       # each warp's pixels: 8x4
        rows, cols = np.divmod(tiles, width)
        big = np.iinfo(np.int64).max
        for a, span in ((rows, 4), (cols, 8)):
            lo = np.where(tiles >= 0, a, big).min(axis=1)
            hi = np.where(tiles >= 0, a, -1).max(axis=1)
            assert (hi - lo < span).all() and (lo % span == 0).all()


def _restated(tstep: np.ndarray, h: int, w: int):
    """Per wave (occupancy, live tiles, max steps) and the chain's
    fused_step_bound over the image's 8x4 blocks."""
    waves, total = [], np.zeros((h, w), np.int64)
    exec_unfused = 0
    for steps in tstep.reshape(-1, h, w).astype(np.int64):
        needed = executed = live = 0
        for y in range(0, h, 4):
            for x in range(0, w, 8):
                blk = steps[y:y + 4, x:x + 8]
                if (blk > 0).any():
                    live += 1
                    needed += blk[blk > 0].sum()
                    executed += blk.max() * blk.size
        total += steps
        exec_unfused += executed
        waves.append((needed / executed, live, int(steps.max())))
    exec_fused = sum(total[y:y + 4, x:x + 8].max()
                     * total[y:y + 4, x:x + 8].size
                     for y in range(0, h, 4) for x in range(0, w, 8))
    return waves, exec_unfused / exec_fused


@pytest.mark.parametrize("scene,w,h", [("flagship", 33, 17), ("maze", 24, 14)])
def test_tool_tile_stats_match_restatement(scene, w, h):
    sc = (flagship_scene if scene == "flagship" else maze_scene)(w, h, "cpu")
    _, _, tstep = occupancy.profile(sc, "cpu")
    got = occupancy.all_stats(tstep.numpy(), h, w, sc.cfg.step_chunk)
    want, bound = _restated(tstep.numpy(), h, w)
    assert len(got["warp_tile"]["waves"]) == len(want) == sc.cfg.n_waves
    for g, (occ, live, smax) in zip(got["warp_tile"]["waves"], want):
        assert abs(g["occupancy"] - occ) < 1e-12
        assert (g["live_groups"], g["steps_max"]) == (live, smax)
    assert abs(got["warp_tile"]["fused_step_bound"] - bound) < 1e-12
