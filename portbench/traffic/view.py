"""Traffic kind "view": one viewpoint walking the scene's camera path.

Step j renders frame k0 + j of the configuration's camera path: the
camera at its frame-0 pose yawed by yaw_step * k and the clock at
sec_step * k, as pwnfps_tpu_torch.scene.Scene.frame_args builds them,
with k0 drawn from the seed (`start_frames` choices), so that every seed
walks the same path from another place.  Each step is one call of the
program's public entry, `render_frame`, or `render_accumulated` where
`samples` > 1; its framebuffer is the step's answer.

The benchmark makes the camera vectors itself (reference/render/camera)
and hands the same ones to the program and to the reference.

Parameters (portbench/traffic/<mix>.json): width, height, reflect,
samples, postproc_blur, yaw_step, sec_step, start_frames, and the
harness's in_flight, warmup_steps, check_frames, check_pixels,
profile_steps and count_steps.
"""

from __future__ import annotations

import importlib

import numpy as np

from ..reference.core.config import RenderConfig as RefConfig
from ..reference.render.camera import camera_vectors, mat4_roty


class View:
    def __init__(self, params: dict, config: dict, root: str, seed: int):
        self.params, self.config, self.root = params, config, root
        self.k0 = seed % int(params["start_frames"])
        self.width, self.height = int(params["width"]), int(params["height"])
        self.samples = int(params["samples"])
        self.parity = bool(config["parity"])
        ref_world = importlib.import_module(
            f"portbench.reference.worlds.{config['world']}")
        self.cam0 = ref_world.camera(config, root)
        self.world = self.meta = self.cfg = self._render = None

    def _fields(self) -> dict:
        p = self.params
        return dict(width=self.width, height=self.height,
                    reflect=int(p["reflect"]),
                    postproc_blur=int(p["postproc_blur"]),
                    parity=self.parity)

    # -- the inputs, made by the benchmark ------------------------------
    def inputs(self, j: int):
        """(origin, rayb, rdx, rdy, sec) float32 of step j."""
        k = self.k0 + j
        c = self.cam0.copy()
        mat4_roty(c, float(self.params["yaw_step"]) * k)
        origin, rayb, rdx, rdy = camera_vectors(c, self.width, self.height)
        return origin, rayb, rdx, rdy, np.float32(
            float(self.params["sec_step"]) * k)

    # -- the program ----------------------------------------------------
    def setup(self, device) -> None:
        """Build the configuration's world through the program."""
        from pwnfps_tpu_torch.core.config import RenderConfig
        from pwnfps_tpu_torch.render.frame import (render_accumulated,
                                                   render_frame)
        worlds = importlib.import_module(
            f"portbench.worlds.{self.config['world']}")
        self.world, self.meta = worlds.build(self.config, self.root, device)
        self.cfg = RenderConfig(**self._fields())
        if self.samples > 1:
            def render(*args):
                return render_accumulated(self.world, self.meta, self.cfg,
                                          *args, samples=self.samples)
        else:
            def render(*args):
                return render_frame(self.world, self.meta, self.cfg, *args)
        self._render = render

    def issue(self, inputs):
        """One program call: (fb [h, w] int32 BGRA bits, zbuf [h, w])."""
        return self._render(*inputs)

    def release(self) -> None:
        self.world = self.meta = self._render = None

    # -- the reference --------------------------------------------------
    def ref_config(self) -> RefConfig:
        return RefConfig(samples=self.samples, **self._fields())

    def ref_world(self, device):
        mod = importlib.import_module(
            f"portbench.reference.worlds.{self.config['world']}")
        return mod.build(self.config, self.root, device)

    def reference(self, rw, frames, ray_dtype=None):
        """[(fb, zbuf)] of the pixels idx of the frame of inputs, for
        each (inputs, idx) of frames, in one plain call."""
        from ..reference.pixels import render_pixels
        return render_pixels(rw.tworld, self.ref_config(), frames,
                             ray_dtype)

    def count(self, rw, inputs_list) -> dict:
        """The work counts of the whole frames of inputs_list, summed,
        with the mode and the number of rays and frames."""
        from ..reference.pixels import count_work
        return {"counts": count_work(rw.tworld, self.ref_config(),
                                     inputs_list),
                "parity": self.parity, "frames": len(inputs_list),
                "rays": self.width * self.height * len(inputs_list)}
