"""Game loop: the host runtime driving the renderer on the card (the
counterpart of pwnfps_tpu/host/loop.py).

Mirrors the reference main loop (main.c:42-381):
  prepare objects -> render -> present -> fps accounting -> script
  on_tick -> input -> player physics/portals.

Each frame rebuilds the world on the host from the object pool
(`ObjectPool.prepare_render`, `worlddev.build_world`), uploads it to the
session's device (`world_to_torch`) and renders it there (`render_frame`:
one trace and one blur launch on the card), as the JAX session does
(pwnfps_tpu/host/loop.py:76-79).  Presentation is headless unless
`--window` opens an SDL2 window: frames are optionally written as PNGs
(nearest-neighbour integer upscale, screen.h:126-149).  Input comes from
a scripted key timeline for deterministic runs.

Usage:
    python -m pwnfps_tpu_torch.host.loop --frames 8 [--out DIR]
        [--level PATH] [--script PATH] [--width 320 --height 200]
        [--device cuda|cpu] [--parity] [--keys 0:forward,30:turnleft]
        [--profile DIR] [--window]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from ..core.approx import SseTables
from ..core.config import DEF_RHEIGHT, DEF_RWIDTH, DEF_SCALE, RenderConfig
from ..ops import worlddev as W
from ..ops.world import world_to_torch
from ..render.camera import camera_vectors
from ..render.frame import fb_to_rgb, frame_rays, render_frame, upscale
from ..script.api import EngineAPI, PythonScript
from ..world.levelc import LevelData, load_level
from ..world.objects import ObjectPool
from . import native
from .physics import Keys, PlayerState, step_player

_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
DEFAULT_LEVEL = os.path.join(_ASSETS, "levels", "demo.txt")
DEFAULT_SCRIPT = os.path.join(_ASSETS, "scripts", "game.py")


def make_script(api: EngineAPI, path: str):
    if path.endswith(".lua"):
        from ..script.luamini import LuaScript
        return LuaScript(api, path)
    return PythonScript(api, path)


class GameSession:
    """The complete engine state + per-frame stepping; renders on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, level_path: str = DEFAULT_LEVEL,
                 script_path: str = DEFAULT_SCRIPT,
                 cfg: RenderConfig | None = None, device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg or RenderConfig()
        self.level: LevelData = load_level(level_path)
        self.pool = ObjectPool()
        self.api = EngineAPI(self.level, self.pool)
        self.script = make_script(self.api, script_path) \
            if script_path else None
        self.player = PlayerState.at_spawn(self.level)
        self.sec = np.float32(0.0)
        self.tables = SseTables.load()
        self.static_word = W.pack_static_word(self.level)
        self.fps = 0.0
        self._fcount = 0
        self._tlastfps = time.perf_counter()

    def build_world(self):
        """This frame's world on the host: (WorldDev, WorldMeta)."""
        sph = self.pool.prepare_render()
        return W.build_world(self.level, sph, self.tables,
                             self.static_word)

    def frame_rays(self):
        """(ifrom, rays, seeds) of this tick's frame on the session's
        device, as render_frame builds them."""
        return frame_rays(self.cfg, *camera_vectors(
            self.player.cam, self.cfg.width, self.cfg.height), self.device)

    def render_device(self, tworld=None, meta=None):
        """(fb int32 [h, w] BGRA bits, zbuf f32 [h, w]) on the session's
        device; the world of build_world, uploaded, unless given."""
        if tworld is None:
            world, meta = self.build_world()
            tworld = world_to_torch(world, meta, self.device)
        origin, rayb, rdx, rdy = camera_vectors(
            self.player.cam, self.cfg.width, self.cfg.height)
        return render_frame(tworld, meta, self.cfg, origin, rayb, rdx, rdy,
                            self.sec)

    def render(self):
        """One frame; returns (fb uint32 [h,w], zbuf f32 [h,w]) on the
        host."""
        fb, zb = self.render_device()
        return (np.ascontiguousarray(fb.cpu().numpy()).view(np.uint32),
                zb.cpu().numpy())

    def tick(self, dt: float, keys: Keys | None = None):
        """Post-render frame logic: clock, script, physics."""
        self.sec = np.float32(self.sec + np.float32(dt))
        if self.script is not None:
            self.script.on_tick(float(self.sec), float(dt))
        step_player(self.level, self.player, dt, keys or Keys())
        self._fcount += 1
        now = time.perf_counter()
        if now - self._tlastfps >= 1.0:
            self.fps = self._fcount / (now - self._tlastfps)
            self._fcount = 0
            self._tlastfps = now


def parse_keys(text: str) -> dict[int, list[str]]:
    """'0:forward,30:turnleft' -> {frame: [key names to toggle]}."""
    toggles: dict[int, list[str]] = {}
    if text:
        for item in text.split(","):
            fr, name = item.split(":")
            toggles.setdefault(int(fr), []).append(name)
    return toggles


def _run(sess: GameSession, args, win) -> int:
    """The frame loop; returns the number of frames rendered."""
    toggles = parse_keys(args.keys)
    keys = Keys()
    tlast = time.perf_counter()
    f = 0
    while f < args.frames or (win is not None and args.frames <= 0):
        for name in toggles.get(f, []):
            setattr(keys, name, not getattr(keys, name))
        fb, _ = sess.render()
        if win is not None:
            win.present(fb)
            live, quit_ = win.poll()
            if quit_:
                break
            # live keys override the scripted timeline (main.c:142-186)
            keys = live
            now = time.perf_counter()
            frame_dt, tlast = now - tlast, now
            win.set_title(f"pwnfps-tpu | {sess.fps:.1f} fps")
        else:
            frame_dt = args.dt
        if args.out:
            from PIL import Image
            img = fb_to_rgb(upscale(fb, args.scale))
            Image.fromarray(img).save(
                os.path.join(args.out, f"frame_{f:04d}.png"))
        sess.tick(frame_dt, keys)
        f += 1
    return f


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--level", default=DEFAULT_LEVEL)
    p.add_argument("--script", default=DEFAULT_SCRIPT)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--width", type=int, default=DEF_RWIDTH)
    p.add_argument("--height", type=int, default=DEF_RHEIGHT)
    p.add_argument("--scale", type=int, default=DEF_SCALE)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--out", default=None,
                   help="directory for PNG frames (requires pillow)")
    p.add_argument("--keys", default="",
                   help="timeline like '0:forward,30:turnleft' "
                        "(frame:key toggles)")
    p.add_argument("--window", action="store_true",
                   help="live SDL2 window + keyboard (needs libSDL2 "
                        "and a display; reference main.c:386-403)")
    p.add_argument("--parity", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the frame renders")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace into DIR")
    args = p.parse_args(argv)

    cfg = RenderConfig(width=args.width, height=args.height,
                       scale=args.scale, parity=args.parity)
    sess = GameSession(args.level, args.script, cfg, args.device)
    win = None
    if args.window:
        from .window import Presenter
        win = Presenter(args.width, args.height, args.scale)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if sess.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = (torch.profiler.profile(activities=acts) if args.profile
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        f = _run(sess, args, win)
    dt = time.perf_counter() - t0
    if win is not None:
        win.close()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
    print(f"{f} frames in {dt:.2f}s "
          f"({f / max(dt, 1e-9):.2f} fps) at {args.width}x{args.height} "
          f"on {sess.device} (host runtime: "
          f"{'native' if native.available() else 'numpy'}), "
          f"player at {sess.player.cam[3, :3]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
