"""The port's game session (pwnfps_tpu_torch/host/loop.py) and the host
modules it copies (physics, snapshot, script API, window, native).

  * a scripted key timeline of 120 ticks on assets/levels/demo.txt with
    assets/scripts/game.py (forward, turns, back, strafe through portal A
    at tick 93; the player settles under gravity at the start): each
    tick's camera, clock and object pool bit-equal to the JAX session's
    `tick` (the JAX session is only constructed, never rendered);
  * the snapshot round trip, and a port snapshot loading in the JAX
    package;
  * tests/test_host.py's end-to-end session check, on the port;
  * 32x24 parity frames of the session at two ticks of the timeline,
    bit-equal to the scalar spec `ScalarTracer(pinned=True)`;
  * the port's Presenter driven by tests/test_window.py's FakeSDL: the
    same SDL calls and Keys as the JAX one;
  * native `prepare_render` equal to the numpy path;
  * the CLI on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from pwnfps_tpu.core import lcg as ref_lcg
from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.host import window as JWn
from pwnfps_tpu.host.loop import GameSession as JaxSession
from pwnfps_tpu.host.snapshot import load_state as jax_load_state
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.world.levelc import load_level as ref_load_level
from pwnfps_tpu.world.objects import ObjectPool as RefPool
from pwnfps_tpu_torch.core.config import RenderConfig
from pwnfps_tpu_torch.host import loop, native
from pwnfps_tpu_torch.host import window as Wn
from pwnfps_tpu_torch.host.physics import Keys
from pwnfps_tpu_torch.host.snapshot import load_state, save_state
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.render.camera import camera_vectors
from pwnfps_tpu_torch.world.objects import K_BUCKET, ObjectPool

from .test_torch_parity import _bits, _replay_gen_rays
from .test_window import FakeSDL, key_event

TICKS = 120
DT = 1.0 / 60.0
# frame:key toggles; the left strafe enters portal A at (7, 1)
TIMELINE = ("0:forward,8:forward,8:turnleft,14:turnleft,14:turnright,"
            "20:turnright,20:back,52:back,52:left,100:left,100:right,"
            "104:right,104:forward,116:forward")
PARITY_TICKS = (0, 96)
FW, FH = 32, 24


def _state(sess):
    n = sess.pool.objs_num
    return (sess.player.cam.copy(), np.float32(sess.sec), n,
            sess.pool.pos[:n].copy(), sess.pool.r[:n].copy(),
            sess.pool.col[:n].copy(), sess.pool.typ[:n].copy())


@pytest.fixture(scope="module")
def sessions():
    """Both sessions stepped through the timeline: each tick's state, and
    the port session's 32x24 parity frames at PARITY_TICKS."""
    cfg = RenderConfig(width=FW, height=FH, parity=True, postproc_blur=0)
    port = loop.GameSession(cfg=cfg, device="cpu")
    ref = JaxSession()
    toggles = loop.parse_keys(TIMELINE)
    keys = Keys()
    states, frames = [], {}
    for f in range(TICKS):
        if f in PARITY_TICKS:
            frames[f] = (port.render(), _state(port),
                         camera_vectors(port.player.cam, FW, FH))
        for name in toggles.get(f, []):
            setattr(keys, name, not getattr(keys, name))
        port.tick(DT, keys)
        ref.tick(DT, Keys(**vars(keys)))
        states.append((_state(port), _state(ref)))
    return states, frames, port


def test_ticks_match_jax_session(sessions):
    states, _, _ = sessions
    for f, (got, want) in enumerate(states):
        for a, b in zip(got, want):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), f
    xs = [s[0][0][3, 0] for s in states]
    # the strafe crossed portal A (7, 1) to its partner at (12, 1)
    assert xs[92] < 7.0 and xs[93] > 12.0
    assert states[-1][0][2] == 14          # the creature's spheres


def test_parity_frames_match_scalar_spec(sessions):
    _, frames, port = sessions
    lv = ref_load_level(loop.DEFAULT_LEVEL)
    xs = np.arange(FW, dtype=np.uint32)
    ys = np.arange(FH, dtype=np.uint32)
    seeds = ref_lcg.pixel_seed(xs[None, :], ys[:, None], FW).reshape(-1)
    for f, ((fb, zb), (cam, sec, n, pos, r, col, typ), vecs) in \
            frames.items():
        pool = RefPool()
        pool.objs_num = n
        pool.typ[:n], pool.r[:n] = typ, r
        pool.pos[:n], pool.col[:n] = pos, col
        pool.refl[:n] = port.pool.refl[:n]
        sw = ScalarWorld(lv, pool.prepare_render(), RefTables.load())
        origin, rayb, rdx, rdy = vecs
        rays = _replay_gen_rays(rayb, rdx, rdy, FW, FH)
        frm = np.array([*origin, 1.0], np.float32)
        cols = np.zeros((FW * FH, 4), np.float32)
        dists = np.zeros(FW * FH, np.float32)
        for i in range(FW * FH):
            tr = ScalarTracer(sw, sec_current=sec, pinned=True)
            ray = np.array([rays[0, i], rays[1, i], rays[2, i], 0.0],
                           np.float32)
            cols[i], dists[i], _ = tr.trace(frm, ray, int(seeds[i]))
        v = cols * np.float32(255.0)
        with np.errstate(invalid="ignore"):
            q = np.clip(np.rint(v), 0.0, 255.0)
            q[(v >= np.float32(2 ** 31)) | np.isnan(v)] = 0
        q = q.astype(np.uint32)
        ref_fb = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
        assert fb.dtype == np.uint32 and fb.shape == (FH, FW)
        assert np.array_equal(fb.reshape(-1), ref_fb), f
        assert np.array_equal(_bits(zb).reshape(-1), _bits(dists)), f


def test_snapshot_roundtrip(tmp_path):
    sess = loop.GameSession(device="cpu")
    sess.player.gravity_y = np.float32(-0.01)
    path = str(tmp_path / "save.npz")
    save_state(path, sess.player, sess.pool, 3.25, {"note": "hi"})
    for load in (load_state, jax_load_state):
        p2, pool2, sec, extra = load(path)
        np.testing.assert_array_equal(p2.cam, sess.player.cam)
        assert p2.gravity_y == sess.player.gravity_y
        assert sec == 3.25 and extra == {"note": "hi"}
        np.testing.assert_array_equal(pool2.pos[:14], sess.pool.pos[:14])


def test_game_session_e2e():
    """tests/test_host.py:126-136 on the port, on the CPU."""
    sess = loop.GameSession(cfg=RenderConfig(width=64, height=32),
                            device="cpu")
    before = tracer.LAUNCHES
    fb, zb = sess.render()
    assert fb.shape == (32, 64) and fb.dtype == np.uint32
    assert zb.shape == (32, 64) and zb.dtype == np.float32
    assert len(np.unique(fb)) > 8       # a real image, not a flat fill
    sess.tick(1 / 60, Keys(forward=True))
    fb2, _ = sess.render()
    assert not np.array_equal(fb, fb2)  # moved camera + animated scene
    assert tracer.LAUNCHES == before    # the CPU runs the plain versions


def test_session_defaults_to_the_card():
    assert loop.GameSession(device="cpu").device == torch.device("cpu")
    assert loop.GameSession.__init__.__defaults__[-1] == "cuda"


def test_presenter_matches_jax():
    ports, refs = (Wn.Presenter(320, 200, 3, sdl=FakeSDL()),
                   JWn.Presenter(320, 200, 3, sdl=FakeSDL()))
    batches = [[key_event(Wn.SDL_KEYDOWN, Wn.SC_UP),
                key_event(Wn.SDL_KEYDOWN, Wn.SC_A)],
               [key_event(Wn.SDL_KEYUP, Wn.SC_UP),
                key_event(Wn.SDL_KEYDOWN, Wn.SC_RIGHT)],
               [key_event(Wn.SDL_KEYDOWN, Wn.SC_ESCAPE)]]
    for batch in batches:
        got, want = [], []
        for pres, out in ((ports, got), (refs, want)):
            pres.sdl.events = list(batch)
            keys, quit_ = pres.poll()
            out.append((vars(keys).copy(), quit_))
        assert got == want
    for pres in (ports, refs):
        pres.present(np.arange(200 * 320, dtype=np.uint32).reshape(200, 320))
        pres.set_title("t")
        pres.close()

    def calls(p):   # pointers differ between the two; names and ints not
        return [(name, tuple(a for a in args if isinstance(a, int)))
                for name, args in p.sdl.calls]
    assert calls(ports) == calls(refs)


def test_native_prepare_render_equals_numpy(monkeypatch):
    assert native.available()            # g++ builds native/presenter.cpp
    pool = ObjectPool()
    rng = np.random.default_rng(1)
    for _ in range(10):
        i = pool.obj_new()
        pool.obj_set_sphere(i, 0.05 + 0.3 * rng.random(), 0.5,
                            2 + 50 * rng.random(), 0.3,
                            2 + 50 * rng.random(), 1, 1, 1)
    pool.obj_free(3)       # free-list hole: skipped by both paths
    nat = pool.prepare_render()
    buckets, counts, masks, n = native.prepare_render_native(pool, K_BUCKET)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    py = pool.prepare_render()
    np.testing.assert_array_equal(counts, py.counts)
    np.testing.assert_array_equal(buckets, py.buckets)
    for f in dataclasses.fields(py):
        np.testing.assert_array_equal(np.asarray(getattr(nat, f.name)),
                                      np.asarray(getattr(py, f.name)))
    assert n == 9


def test_cli_on_cpu(capsys):
    assert loop.main(["--frames", "2", "--device", "cpu", "--width", "32",
                      "--height", "24"]) == 0
    assert "2 frames" in capsys.readouterr().out
