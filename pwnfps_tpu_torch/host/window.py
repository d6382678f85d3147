"""Live SDL2 window + keyboard for the host loop (reference
Copied from pwnfps_tpu/host/window.py.
main.c:142-186, 386-403).

A headless host has no display server or SDL, so this binds libSDL2 at
RUNTIME via ctypes (no headers, no compile step): on a desktop with SDL2
installed, `python -m pwnfps_tpu_torch.host.loop --window` opens the reference
960x600-style window, blits the upscaled BGRA framebuffer (SDL converts
pixel formats via a wrapping surface + blit, the SDL2 analogue of
main.c:108-109's upscale+SDL_Flip), and feeds live key events into
host.physics.Keys with the reference's bindings: arrows turn/move,
WASD strafes/moves, ESC or window-close quits.

Everything testable is dependency-injected: Presenter takes the loaded
library object, so tests drive it with a fake (tests/test_window.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import signal

import numpy as np

from .physics import Keys

# SDL2 constants (SDL_video.h / SDL_events.h / SDL_scancode.h)
SDL_INIT_VIDEO = 0x20
SDL_WINDOWPOS_CENTERED = 0x2FFF0000
SDL_QUIT = 0x100
SDL_KEYDOWN = 0x300
SDL_KEYUP = 0x301
# SDL_KeyboardEvent: u32 type, u32 timestamp, u32 windowID, u8 state,
# u8 repeat, u8[2] pad, SDL_Keysym{i32 scancode, ...}
_SCANCODE_OFF = 16

SC_A, SC_D, SC_S, SC_W = 4, 7, 22, 26
SC_ESCAPE = 41
SC_RIGHT, SC_LEFT, SC_DOWN, SC_UP = 79, 80, 81, 82

# reference bindings (main.c:142-186): arrows turn left/right and move
# forward/back, WASD moves/strafes
_KEYMAP = {
    SC_LEFT: "turnleft",
    SC_RIGHT: "turnright",
    SC_UP: "forward",
    SC_DOWN: "back",
    SC_W: "forward",
    SC_S: "back",
    SC_A: "left",
    SC_D: "right",
}


def load_sdl():
    """dlopen libSDL2; None when unavailable (headless hosts)."""
    for name in ("SDL2-2.0", "SDL2"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    for soname in ("libSDL2-2.0.so.0", "libSDL2.so"):
        try:
            return ctypes.CDLL(soname)
        except OSError:
            continue
    return None


class Presenter:
    """SDL2 window presenting uint32 BGRA frames + polling Keys.

    sdl: a loaded SDL2 library object (load_sdl()), or a test fake
    exposing the same entry points."""

    def __init__(self, width: int, height: int, scale: int, sdl=None,
                 title: bytes = b"pwnfps-tpu"):
        self.sdl = sdl if sdl is not None else load_sdl()
        if self.sdl is None:
            raise RuntimeError(
                "libSDL2 not found - install SDL2 or run headless "
                "(--out DIR)")
        self.w, self.h, self.scale = width, height, scale
        sdl = self.sdl
        sdl.SDL_CreateWindow.restype = ctypes.c_void_p
        sdl.SDL_GetWindowSurface.restype = ctypes.c_void_p
        sdl.SDL_CreateRGBSurfaceFrom.restype = ctypes.c_void_p
        sdl.SDL_GetError.restype = ctypes.c_char_p
        if sdl.SDL_Init(SDL_INIT_VIDEO) != 0:
            raise RuntimeError(f"SDL_Init: {sdl.SDL_GetError()}")
        # the reference resets fatal signal handlers so crashes crash
        # properly (main.c:389-390, SDL_INIT_NOPARACHUTE's SDL2 analogue)
        try:
            signal.signal(signal.SIGINT, signal.SIG_DFL)
        except ValueError:
            pass                      # not on the main thread (tests)
        self.win = sdl.SDL_CreateWindow(
            ctypes.c_char_p(title),
            SDL_WINDOWPOS_CENTERED, SDL_WINDOWPOS_CENTERED,
            width * scale, height * scale, 0)
        if not self.win:
            raise RuntimeError(f"SDL_CreateWindow: {sdl.SDL_GetError()}")
        self.keys = Keys()
        self._ev = ctypes.create_string_buffer(64)

    def present(self, fb: np.ndarray):
        """Blit an [h,w] uint32 BGRA frame, upscaled (screen.h:126-149
        + SDL_Flip, main.c:108-109)."""
        from ..render.frame import upscale
        big = np.ascontiguousarray(upscale(fb, self.scale))
        sdl = self.sdl
        h, w = big.shape
        src = sdl.SDL_CreateRGBSurfaceFrom(
            big.ctypes.data_as(ctypes.c_void_p), w, h, 32, w * 4,
            0x00FF0000, 0x0000FF00, 0x000000FF, 0)   # BGRA byte order
        dst = sdl.SDL_GetWindowSurface(ctypes.c_void_p(self.win))
        sdl.SDL_UpperBlit(ctypes.c_void_p(src), None,
                          ctypes.c_void_p(dst), None)
        sdl.SDL_FreeSurface(ctypes.c_void_p(src))
        sdl.SDL_UpdateWindowSurface(ctypes.c_void_p(self.win))

    def poll(self) -> tuple[Keys, bool]:
        """Drain pending events -> (current Keys, quit?)."""
        quit_ = False
        sdl = self.sdl
        while sdl.SDL_PollEvent(self._ev):
            etype = int.from_bytes(self._ev.raw[0:4], "little")
            if etype == SDL_QUIT:
                quit_ = True
            elif etype in (SDL_KEYDOWN, SDL_KEYUP):
                sc = int.from_bytes(
                    self._ev.raw[_SCANCODE_OFF:_SCANCODE_OFF + 4],
                    "little")
                if sc == SC_ESCAPE:
                    quit_ = quit_ or etype == SDL_KEYDOWN
                name = _KEYMAP.get(sc)
                if name is not None:
                    setattr(self.keys, name, etype == SDL_KEYDOWN)
        return self.keys, quit_

    def set_title(self, text: str):
        self.sdl.SDL_SetWindowTitle(ctypes.c_void_p(self.win),
                                    text.encode())

    def close(self):
        if self.win:
            self.sdl.SDL_DestroyWindow(ctypes.c_void_p(self.win))
            self.win = None
        self.sdl.SDL_Quit()
