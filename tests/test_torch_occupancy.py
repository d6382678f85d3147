"""The port's occupancy tool (pwnfps_tpu_torch/tools/occupancy.py)
against the JAX package's tools/occupancy.py.

  * On a 64x32 frame of the portal chain (config #2's scene), the port's
    TPU-tile statistics (from the profile instance's per-wave tstep)
    equal `wave_stats` of the JAX tool, which traces the same rays with
    the jnp backend: integers exactly, ratios within 1e-6, and the JAX
    tool's three-decimal summary exactly;
  * the warp and block groupings on a hand-built tstep;
  * the tool's main on the CPU at a tiny size."""

import importlib.util
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from pwnfps_tpu.core.config import RenderConfig as JaxRenderConfig
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu.render.frame import gen_rays as jax_gen_rays
from pwnfps_tpu_torch.render.frame import pixel_seeds
from pwnfps_tpu_torch.scene import stress_scene
from pwnfps_tpu_torch.tools import occupancy

W_, H_ = 64, 32


def _jax_tool():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "occupancy.py")
    spec = importlib.util.spec_from_file_location("jax_occupancy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chain():
    """(port stats, JAX tool's waves and summary) of the chain frame."""
    sc = stress_scene(W_, H_, "cpu")
    _, _, tstep = occupancy.profile(sc, "cpu")
    port = occupancy.all_stats(tstep.numpy(), H_, W_, sc.cfg.step_chunk)
    origin, rayb, rdx, rdy, _ = sc.frame_args(0)
    rays = jax_gen_rays(jnp.asarray(rayb), jnp.asarray(rdx),
                        jnp.asarray(rdy), W_, H_, parity=False)
    n = W_ * H_
    ifrom = JV3(*(jnp.full(n, origin[i]) for i in range(3)))
    seeds = jnp.asarray(pixel_seeds(W_, H_, "cpu").numpy().view(np.uint32))
    cfg = JaxRenderConfig(width=W_, height=H_, parity=False, backend="jnp",
                          profile=True, reflect=sc.cfg.reflect)
    waves, summary = _jax_tool().wave_stats(
        sc.world, sc.meta, cfg, ifrom, rays, seeds, occupancy.SEC, H_, W_)
    return port, waves, summary


def test_tile_stats_match_jax_tool(chain):
    port, waves, summary = chain
    tile = port["tile"]
    assert len(tile["waves"]) == len(waves) == 3
    for got, want in zip(tile["waves"], waves):
        for key in ("wave", "steps_max"):
            assert got[key] == want[key], key
        assert got["live_groups"] == want["live_tiles"]
        for key in ("live_frac", "steps_p50", "steps_p99", "occupancy"):
            assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    for key in ("fused_step_bound", "needed_frac_unfused"):
        assert round(tile[key], 3) == summary[key], key
    # the frame has work in every wave
    assert all(w["steps_max"] > 0 for w in waves)


def test_warp_and_block_groupings():
    # 96 lanes: warp 0 all 4 steps; warp 1 one lane of 10, the rest 1;
    # warp 2 not live in wave 0; wave 1 only lane 0
    t = np.zeros((2, 96), np.int64)
    t[0, :32] = 4
    t[0, 32:64] = 1
    t[0, 40] = 10
    t[1, 0] = 3
    ids, lanes = occupancy.lockstep_ids(96, occupancy.WARP)
    waves, s = occupancy.wave_stats(t, ids, lanes)
    needed0 = 32 * 4 + 31 * 1 + 10
    assert waves[0]["occupancy"] == needed0 / (32 * 4 + 32 * 10)
    assert waves[0]["live_groups"] == 2 and waves[0]["steps_max"] == 10
    assert waves[0]["live_frac"] == 64 / 96
    assert waves[1]["occupancy"] == 3 / (32 * 3)
    assert waves[1]["live_groups"] == 1
    # fused: warp 0 runs lane 0's 7 steps, warp 1 its 10
    assert s["needed_frac_fused"] == (needed0 + 3) / (32 * 7 + 32 * 10)
    assert s["fused_step_bound"] == (32 * 4 + 32 * 10 + 32 * 3) / (
        32 * 7 + 32 * 10)
    # one block of 96 (short): every lane in one lockstep group
    bids, blanes = occupancy.lockstep_ids(96, occupancy.BLOCK)
    assert blanes.tolist() == [96]
    bw, _ = occupancy.wave_stats(t, bids, blanes)
    assert bw[0]["occupancy"] == needed0 / (96 * 10)


def test_tool_main_on_cpu(tmp_path):
    out = tmp_path / "occ.json"
    assert occupancy.main(["maze", "--device", "cpu", "--width", "16",
                           "--height", "8", "--out", str(out)]) == 0
    res = json.loads(out.read_text())["maze"]
    assert res["res"] == "16x8" and res["device"] == "cpu"
    assert {"tile", "warp", "block"} <= set(res)
    assert len(res["warp"]["waves"]) == res["reflect"] + 1
