"""The port's multi-device path (pwnfps_tpu_torch/parallel/sharding.py) on
a mesh of CPU devices, against the port's one-device path and the JAX
package.

(a) `dof_blur_band_plain` equals JAX `dof_blur_band` and the same rows
    of `dof_blur_plain`, bit for bit, for every band of the three cases
    of tests/test_blur_sharded.py and for two stacked cameras;
(b) `_dof_blur_mesh` on a (2, 4) mesh equals the per-camera
    `dof_blur_plain` bit for bit: one frame over all 8 devices (40 rows:
    8-row bands, six hops) and cameras over "cam" with rows over "px",
    each in the banded and the flat layout, 1 and 2 passes, frames whose
    reach sits just under 47.5 rows; at zmax 4000 the gathered fallback
    runs, counted once a pass (the bench camera's first frame takes it
    at 1080p, chip_smoke phase 11b);
(c) `render_frame_sharded` at 96x64 (banded: 8-row bands) and 96x40
    (flat) equals `render_frame` bit for bit in fb and zbuf, each
    device's band holding only its own rows; the 96x64 frame agrees
    with JAX's `render_frame_sharded` on its 8 virtual CPU devices
    within the fast-mode frame limits of tests/test_torch_frame.py;
(d) `render_cameras` on a (2, 4) mesh, 4 cameras of 64x32 with one DoF
    pass (banded) and of 64x24 (flat), equals `mesh=None` bit for bit;
    the 64x32 batch agrees with JAX's `render_cameras` on a (2, 4) mesh
    within the same limits;
(e) parity mode, cameras that do not split over the cam axis and a
    device count that does not fill the mesh raise ValueError.

Cameras stand off the cell centres (tests/test_torch_cameras.py says
why).  The two JAX compiles (the sharded frame and the meshed camera
batch) run in two threads."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops.blur import dof_blur_band as jax_dof_blur_band
from pwnfps_tpu.parallel.sharding import make_mesh as jax_make_mesh
from pwnfps_tpu.parallel.sharding import render_cameras as jax_cameras
from pwnfps_tpu.parallel.sharding import \
    render_frame_sharded as jax_frame_sharded
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.parallel import sharding as S
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import flagship_scene, mesh_for, multicam_scene

MESH = S.make_mesh(2, 4, ["cpu"] * 8)
OFF = (0.13, 0.07)          # camera offset from the cell centre, x and z


def _frames(c, h, w, zmax, seed, reach_row=None):
    """c random frames: fb uint32 bits in int32, zbuf in [1, zmax] with
    a band of near-focus rows; reach_row puts zmax on that row."""
    rng = np.random.default_rng(seed)
    fb = rng.integers(0, 2 ** 32, (c, h, w), dtype=np.uint64)
    z = rng.uniform(1.0, zmax, (c, h, w)).astype(np.float32)
    z[:, h // 3:h // 2] = 1.01
    if reach_row is not None:
        z[:, reach_row, 5] = zmax
    return (torch.from_numpy(fb.astype(np.uint32).view(np.int32)),
            torch.from_numpy(z))


def _pad_band(fb, y0, hb, H):
    """Rows [y0-H, y0+hb+H) of [c, h, w] fb, zero-filled outside."""
    fp = torch.nn.functional.pad(fb, (0, 0, H, H + hb))
    return fp[:, y0:y0 + hb + 2 * H]


# ---- (a) the band blur -----------------------------------------------------

@pytest.mark.parametrize("h,w,zmax,hb,H,cl", [
    (64, 130, 5.0, 16, 16, 1),     # interior + both frame edges, w % 4
    (64, 256, 120.0, 16, 48, 1),   # taps past one band
    (40, 96, 3.0, 8, 8, 1),        # tiny bands
    (48, 130, 60.0, 16, 48, 2),    # two stacked cameras
])
def test_band_blur_matches_jax_and_full(h, w, zmax, hb, H, cl):
    fb, z = _frames(cl, h, w, zmax, seed=h + w + cl)
    full = torch.stack([blur.dof_blur_plain(fb[c], z[c]) for c in range(cl)])
    jband = jax.jit(jax_dof_blur_band, static_argnames="fh")
    for y0 in range(0, h, hb):
        fp = _pad_band(fb, y0, hb, H).contiguous()
        zb = z[:, y0:y0 + hb].contiguous()
        got = blur.dof_blur_band(fp, zb, y0, h)
        assert got.shape == (cl, hb, w) and got.dtype == torch.int32
        assert torch.equal(got, full[:, y0:y0 + hb]), f"band y0={y0}"
        for c in range(cl):
            want = np.asarray(jband(
                jnp.asarray(fp[c].numpy().view(np.uint32)),
                jnp.asarray(zb[c].numpy()), jnp.int32(y0), fh=h))
            assert np.array_equal(got[c].numpy().view(np.uint32), want), \
                f"camera {c} band y0={y0} != JAX"


# ---- (b) the mesh blur ------------------------------------------------------

def test_halo_hops():
    # multicam's 32-row bands over px take two hops, 40 rows over 8
    # devices (8-row bands) six, one band none
    assert S._halo(32, 4) == (2, 48)
    assert S._halo(8, 8) == (6, 48)
    assert S._halo(8, 2) == (1, 8)
    assert S._halo(64, 1) == (0, 0)


@pytest.mark.parametrize("axes,banded,c,h,w,zmax,passes", [
    ("frame", False, 1, 40, 64, 594.0, 1),     # six hops; reach 47.44
    ("frame", False, 1, 64, 130, 371.0, 2),    # reach 47.36
    ("frame", True, 1, 64, 96, 371.0, 1),      # the sharded frame's bands
    ("cams", True, 4, 32, 64, 742.0, 1),       # the halo spans the frame
    ("cams", False, 4, 120, 96, 198.5, 2),     # 32-row bands, two hops
    ("frame", False, 1, 32, 96, 4000.0, 1),    # fallback
    ("frame", True, 1, 64, 96, 4000.0, 1),     # fallback, frame bands
    ("cams", True, 4, 32, 64, 4000.0, 2),      # fallback, two passes
])
def test_mesh_blur_matches_per_camera(axes, banded, c, h, w, zmax, passes):
    fb, z = _frames(c, h, w, zmax, seed=h * w + passes, reach_row=h - 1)
    cfg = dataclasses.replace(flagship_scene(w, h, "cpu").cfg,
                              postproc_blur=passes)
    axes = ((), S.AXES) if axes == "frame" else (("cam",), ("px",))
    S.FALLBACKS = 0
    before = (blur.LAUNCHES, blur.LAUNCHES_BAND)
    if banded:
        nrow = MESH.size if not axes[0] else MESH.shape["px"]
        rloc = S._band_rows(cfg, nrow)
        pad = (0, 0, 0, rloc * nrow - h)
        parts = S._dof_blur_mesh(
            S._split(torch.nn.functional.pad(fb, pad), MESH, *axes, rloc),
            S._split(torch.nn.functional.pad(z, pad, value=1.0), MESH,
                     *axes, rloc), cfg, MESH, *axes, band=rloc, real_h=h)
    else:
        parts = S._dof_blur_mesh(fb, z, cfg, MESH, *axes)
    assert (blur.LAUNCHES, blur.LAUNCHES_BAND) == before   # CPU: plain
    assert all(p.device == torch.device("cpu") for p in parts)
    got = S._gather(parts, MESH, *axes)[:, :h]
    want = torch.stack([blur.dof_blur_plain(fb[k], z[k], passes)
                        for k in range(c)])
    assert torch.equal(got, want)
    reach = float(np.float32((z - 1).abs().max()) * np.float32(0.002 * h))
    assert S.FALLBACKS == (passes if zmax == 4000.0 else 0), reach
    assert (reach < 47.5) == (zmax < 4000.0)


# ---- (c), (d): the sharded renders ------------------------------------------

def _frame_limits(fb, zb, jfb, jzb):
    """tests/test_torch_frame.py's fast-mode frame limits."""
    fb = fb.numpy().view(np.uint32)
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    msg = f"fb {fb_bit:.5f} bit-exact, max byte diff {db}"
    assert fb_bit >= 0.999 and db <= 64, msg
    if zb is not None:
        zb = zb.numpy()
        z_bit = np.mean(zb.view(np.uint32) == jzb.view(np.uint32))
        dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
        assert dz.max() <= 1e-5 and z_bit >= 0.5, (z_bit, dz.max())


@pytest.fixture(scope="module")
def renders():
    """The port's sharded frame and meshed camera batch, and JAX's, the
    two JAX compiles in two threads."""
    fr = flagship_scene(96, 64, "cpu")
    fr.cam[3, 0] += OFF[0]
    fr.cam[3, 2] += OFF[1]
    fargs = fr.frame_args(3)
    mc = multicam_scene("cpu", n_cams=4, width=64, height=32,
                        postproc_blur=1)
    cams, sec = mc.step_args(3)
    cams = cams.copy()
    cams[:, 3, 0] += OFF[0]
    cams[:, 3, 2] += OFF[1]
    jmesh = jax_make_mesh(2, 4, jax.devices()[:8])
    with ThreadPoolExecutor(2) as pool:
        jfr = pool.submit(lambda: [np.asarray(a) for a in jax_frame_sharded(
            jax.tree.map(jnp.asarray, fr.world), fr.meta, fr.cfg,
            *fargs[:4], fargs[4], jmesh)])
        jmc = pool.submit(lambda: np.asarray(jax_cameras(
            jax.tree.map(jnp.asarray, mc.world), mc.meta, mc.cfg, cams, sec,
            jmesh)))
        before = (tracer.LAUNCHES, blur.LAUNCHES, blur.LAUNCHES_BAND)
        out = dict(
            frame=fr, fargs=fargs,
            sharded=S.render_frame_sharded(fr.tworld, fr.meta, fr.cfg,
                                           *fargs, MESH),
            single=render_frame(fr.tworld, fr.meta, fr.cfg, *fargs),
            cams=(mc, cams, sec),
            cams_mesh=S.render_cameras(mc.tworld, mc.meta, mc.cfg, cams, sec,
                                       MESH),
            cams_one=S.render_cameras(mc.tworld, mc.meta, mc.cfg, cams, sec))
        out["launches"] = (tracer.LAUNCHES, blur.LAUNCHES,
                           blur.LAUNCHES_BAND) == before
        out["jframe"], out["jcams"] = jfr.result(), jmc.result()
    return out


def test_sharded_frame_equals_render_frame(renders):
    fb, zb = renders["sharded"]
    fb1, zb1 = renders["single"]
    assert fb.shape == (64, 96) and zb.shape == (64, 96)
    assert torch.equal(fb, fb1)
    assert torch.equal(zb.view(torch.int32), zb1.view(torch.int32))
    assert torch.unique(fb).numel() > 100
    assert renders["launches"]           # CPU tensors: no kernel launched


def test_sharded_frame_bands_hold_own_rows(renders):
    sc = renders["frame"]
    tws = S.replicate_world(sc.world, sc.meta, MESH)
    assert len(tws) == 1                 # repeated devices share a world
    fbs, zbs = S._render_frame_mesh_banded(tws, sc.cfg, MESH,
                                           *renders["fargs"])
    rloc = S._band_rows(sc.cfg, MESH.size)
    assert rloc == 8 and len(fbs) == len(zbs) == 8
    fb1, _ = renders["single"]
    for k, (f, z) in enumerate(zip(fbs, zbs)):
        assert f.shape == z.shape == (rloc, 96)
        assert torch.equal(f, fb1[k * rloc:(k + 1) * rloc])


def test_sharded_frame_matches_jax_relaxed(renders):
    fb, zb = renders["sharded"]
    jfb, jzb = renders["jframe"]
    _frame_limits(fb, zb, jfb, jzb)


def test_flat_sharded_frame_equals_render_frame():
    sc = flagship_scene(96, 40, "cpu")
    assert S._band_rows(sc.cfg, MESH.size) == 0
    args = sc.frame_args(2)
    S.FALLBACKS = 0
    fb, zb = S.render_frame_sharded(sc.world, sc.meta, sc.cfg, *args, MESH)
    fb1, zb1 = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    assert torch.equal(fb, fb1)
    assert torch.equal(zb.view(torch.int32), zb1.view(torch.int32))
    assert S.FALLBACKS == 0


def test_meshed_cameras_equal_one_device(renders):
    got, want = renders["cams_mesh"], renders["cams_one"]
    assert got.shape == (4, 32, 64) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_meshed_cameras_match_jax_relaxed(renders):
    fb, jfb = renders["cams_mesh"], renders["jcams"]
    assert jfb.shape == (4, 32, 64)
    for c in range(4):
        _frame_limits(fb[c], None, jfb[c], None)


def test_flat_meshed_cameras_equal_one_device(renders):
    mc, cams, sec = renders["cams"]
    cfg = dataclasses.replace(mc.cfg, height=24, postproc_blur=2)
    assert S._band_rows(cfg, MESH.shape["px"]) == 0
    got = S.render_cameras(mc.world, mc.meta, cfg, cams, sec,
                           mesh_for(2, 4, "cpu"))
    assert torch.equal(got, S.render_cameras(mc.tworld, mc.meta, cfg, cams,
                                             sec))


# ---- (e) what the mesh refuses ---------------------------------------------

def test_mesh_rejects(renders):
    sc = renders["frame"]
    mc, cams, sec = renders["cams"]
    with pytest.raises(ValueError, match="fast-mode only"):
        S.render_frame_sharded(sc.tworld, sc.meta,
                               dataclasses.replace(sc.cfg, parity=True),
                               *renders["fargs"], MESH)
    with pytest.raises(ValueError, match="fast-mode only"):
        S.render_cameras(mc.tworld, mc.meta,
                         dataclasses.replace(mc.cfg, parity=True), cams, sec,
                         MESH)
    with pytest.raises(ValueError, match="camera shards"):
        S.render_cameras(mc.tworld, mc.meta, mc.cfg, cams[:3], sec, MESH)
    with pytest.raises(ValueError, match="devices"):
        S.make_mesh(2, 4, ["cpu"] * 7)
    with pytest.raises(ValueError, match="numpy world"):
        S.replicate_world(mc.tworld, mc.meta,
                          S.make_mesh(1, 2, ["cpu", "meta"]))
