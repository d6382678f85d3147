"""Scripting API: the 5-function contract of the reference's Lua layer.
Copied from pwnfps_tpu/script/api.py.

The reference registers obj_new/obj_set/obj_free/level_get/level_set in
an embedded Lua 5.1 VM (script.h:71-102) and calls the
script's global `on_tick(sec, dt)` every frame (main.c:127-140, fatal if
missing or failing).  Here the same contract binds to the object pool +
level; frontends: native Python scripts (this module) and Lua scripts
via the bundled mini-Lua interpreter (pwnfps_tpu_torch.script.luamini).

NOTE for Lua script authors: luamini is a deliberate Lua 5.1 SUBSET
(the reference links the full liblua, script.h:75-77).  Supported:
functions/closures, tables, control flow, arithmetic/relational/
logical ops, metatables with the 5.1 core metamethods (__index/
__newindex chains, __call, __tostring, __eq/__lt/__le, arithmetic/
__concat/__unm, __metatable protection), ':'-method calls and
`function t:m()` definition sugar, string methods via ':' (s:sub(..)),
the full Lua 5.1 pattern language (string.find/match/gmatch/gsub:
classes, sets, captures incl. position captures, %1-%9 back-
references, %bxy, %f[set], anchors, all quantifiers), coroutines
(create/resume/yield/status/running/wrap), loadstring/load, and a
stdlib subset (math.*, string.format/len/sub/rep/upper/lower/byte/
char/reverse, table.insert/remove/concat/sort/getn/foreach(i), os.time/clock/date/getenv,
io.write/read, print, tostring, tonumber, type, pairs/ipairs,
pcall/error/assert, unpack, select, rawget/rawset/rawequal,
set/getmetatable).  NOT supported: goto/labels (5.2+), require/
module, io files beyond write/read, string.dump, weak tables/__gc,
__len on tables.  The reference's game.lua runs verbatim
(tests/test_luamini.py); scripts needing the excluded constructs
belong in the Python frontend (assets/scripts/game.py is the twin).
"""

from __future__ import annotations

from ..world.levelc import LevelData
from ..world.objects import ObjectPool


class EngineAPI:
    """Bound engine functions exposed to game scripts."""

    def __init__(self, level: LevelData, pool: ObjectPool):
        self._lv = level
        self._pool = pool

    # script.h:1-8
    def obj_new(self):
        return self._pool.obj_new()

    # script.h:10-40 - typ must be "sphere" (case-insensitive)
    def obj_set(self, pt, typ, r, refl, x, y, z, b, g, rr):
        if pt is None:
            raise ValueError("obj_set: pt cannot be nil")
        if typ is None:
            raise ValueError("obj_set: typ cannot be nil")
        if str(typ).lower() != "sphere":
            raise ValueError(f'obj_set: invalid typ "{typ}"')
        self._pool.obj_set_sphere(int(pt), r, refl, x, y, z, b, g, rr)
        return pt

    # script.h:42-51
    def obj_free(self, pt):
        if pt is None:
            raise ValueError("obj_free: pt cannot be nil")
        self._pool.obj_free(int(pt))

    # script.h:53-63 - returns a 1-char string, OOB clamps to (0,0)
    def level_get(self, cx, cz):
        return chr(self._lv.get_cell(int(cx), int(cz)))

    # script.h:65-69 - stub no-op upstream; kept for contract parity
    def level_set(self, *args):
        return None

    def bindings(self) -> dict:
        return {
            "obj_new": self.obj_new,
            "obj_set": self.obj_set,
            "obj_free": self.obj_free,
            "level_get": self.level_get,
            "level_set": self.level_set,
        }


class ScriptError(RuntimeError):
    pass


class PythonScript:
    """Run a Python game script with the engine bindings as globals.

    The script must define on_tick(sec_current, sec_delta); like the
    reference, a missing or failing on_tick is fatal (main.c:128-140).
    """

    def __init__(self, api: EngineAPI, path: str):
        self.globals = dict(api.bindings())
        with open(path, "r") as f:
            src = f.read()
        exec(compile(src, path, "exec"), self.globals)  # runs top level
        if "on_tick" not in self.globals:
            raise ScriptError("on_tick not defined")

    def on_tick(self, sec: float, dt: float) -> None:
        try:
            self.globals["on_tick"](sec, dt)
        except Exception as e:
            raise ScriptError(f"on_tick broke ({e})") from e
