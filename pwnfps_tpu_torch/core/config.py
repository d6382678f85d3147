"""Engine configuration.  Copied from pwnfps_tpu/core/config.py.

The reference engine hardcodes everything as compile-time #defines
(defs.h:1-23).  Here the same knobs are a frozen dataclass; the field
names, defaults and meanings are those of the JAX package, so a config
of either package describes the same frame.
"""

from __future__ import annotations

import dataclasses

# --- constants mirrored from the reference operating point -----------------
# defs.h:1   EPSILON
EPSILON = 1e-13
# defs.h:6   REFLECT_BLUR
REFLECT_BLUR = 0.03
# defs.h:7   PLAYER_BBOX
PLAYER_BBOX = 0.2
# defs.h:8   REFLECT (max bounce depth)
REFLECT = 2
# defs.h:9   POSTPROC_BLUR passes
POSTPROC_BLUR = 1
# defs.h:11-15 default internal res + integer upscale
DEF_SCALE = 3
DEF_RWIDTH = 320
DEF_RHEIGHT = 200
# trace.h:247 DDA step budget per ray segment
MAXSTEPS = 1000

# Palette (b, g, r) float triples - defs.h:17-19.  Colours keep the
# reference's SSE lane order (b, g, r, a) end to end and only swap to RGB
# when exporting images.
COL_CEIL = (30.0, 30.0, 0.0)
COL_FLOOR = (1.0, 1.0, 1.0)
COL_WALL = (0.8, 0.8, 1.0)
# wrong-endpoint portal debug colour - trace.h:558
COL_MAGENTA = (5.0, 0.0, 5.0)

# Face direction codes - defs.h:25-33.  The X/Z face codes live in 0..3
# so a quarter-turn portal rotation is `(ldir - rot) & 3` (trace.h:576).
FXP = 0
FZP = 1
FXN = 2
FZN = 3
FYP = 4
FYN = 5


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.  The knobs below `space_skip` tune or
    probe the TPU kernel's layout (pwnfps_tpu/core/config.py documents
    each); the port accepts the layout knobs, which leave the bits
    unchanged, and raises on the others (tracer_core.check_config)."""

    width: int = DEF_RWIDTH
    height: int = DEF_RHEIGHT
    scale: int = DEF_SCALE
    reflect: int = REFLECT          # bounce depth cap (number of extra waves)
    maxsteps: int = MAXSTEPS        # DDA trip budget per segment
    reflect_blur: float = REFLECT_BLUR
    postproc_blur: int = POSTPROC_BLUR
    # parity=True reproduces the reference's approximate SSE intrinsics
    # (rsqrt/rcp lookup tables), its correctly rounded div/sqrt, the
    # pinned libm and the serial ray-offset accumulation, for
    # pixel-exact comparison; parity=False uses the hardware math.
    parity: bool = False
    backend: str = "jnp"
    step_chunk: int = 2
    # empty-space skip (fast mode only; parity mode always steps one
    # cell like the reference)
    space_skip: bool = True
    water: bool = True
    profile: bool = False
    cam_page: int = 0
    pack_carry: bool = True
    span_fetch: int = 0
    tile_rect: tuple | None = None
    trace_2d: bool = True
    mesh_bands: bool = True
    fused: bool = False
    probe: str = ""
    samples: int = 1

    @property
    def n_waves(self) -> int:
        # primary segment + up to `reflect` bounce segments
        return self.reflect + 1
