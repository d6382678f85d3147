"""The port's copy of luamini (pwnfps_tpu_torch/script/luamini.py)
against the JAX package's: inline Lua game scripts, written as
tests/test_luamini.py writes its scripts, run through both `LuaScript`s
against a recording engine API.  Each must make the same API calls with
the same values, at load and over a few `on_tick` calls, and end with
the same plain globals; a script that fails raises each package's
ScriptError."""

import math

import pytest

from pwnfps_tpu.script import api as jax_api
from pwnfps_tpu.script import luamini as jax_luamini
from pwnfps_tpu_torch.script import api, luamini


class RecordingAPI:
    """The five engine bindings, recording each call and its arguments;
    level_get reads a fixed pattern."""

    def __init__(self):
        self.calls = []
        self._next = 0

    def _obj_new(self):
        self._next += 1
        return self._next

    def bindings(self) -> dict:
        impl = {"obj_new": self._obj_new,
                "obj_set": lambda pt, *a: pt,
                "obj_free": lambda pt: None,
                "level_get": lambda cx, cz:
                    "#" if (int(cx) * 7 + int(cz)) % 3 == 0 else ";",
                "level_set": lambda *a: None}

        def rec(name, fn):
            def call(*args):
                self.calls.append((name, args))
                return fn(*args)
            return call
        return {name: rec(name, fn) for name, fn in impl.items()}


SCRIPTS = {
    "creature": """
        local parts = {}
        for i = 1, 4 do
          parts[i] = obj_new()
          obj_set(parts[i], "sphere", 0.1 * i, 0.5, 3 + i, 0.3, 5, 1, 0.5, 0)
        end
        function on_tick(sec, dt)
          for i, p in ipairs(parts) do
            local a = sec * 2 + i * math.pi / 2
            obj_set(p, "SPHERE", 0.1, 0.4, 3.5 + math.cos(a) * 0.3, 0.3,
                    5.5 + math.sin(a) * 0.3, 0.8, 0.8, 0.8)
          end
        end
    """,
    "walker": """
        x, z, dir = 3.5, 5.5, 1
        me = obj_new()
        function on_tick(sec, dt)
          local nx = x + dir * dt * 2
          if level_get(math.floor(nx), math.floor(z)) == "#" then
            dir = -dir
          else
            x = nx
          end
          obj_set(me, "sphere", 0.3, 0.6, x, 0.3, z, 1, 1, 1)
        end
    """,
    "strings_tables": """
        names = {}
        for w in string.gmatch("alpha beta gamma", "%a+") do
          table.insert(names, string.upper(w))
        end
        label = table.concat(names, ",") .. string.format(" %5.2f", 1 / 3)
        t = setmetatable({}, {__index = function(t, k) return k * 2 end})
        function on_tick(sec, dt)
          level_set(1, 2, "#")
          obj_set(obj_new(), "sphere", #label, t[21], sec, dt, 0, 0, 0, 0)
        end
    """,
    "coroutines_pcall": """
        gen = coroutine.wrap(function()
          for i = 1, 3 do coroutine.yield(i * i) end
        end)
        ok, err = pcall(function() error("boom") end)
        function on_tick(sec, dt)
          local v = gen()
          if v then obj_set(obj_new(), "sphere", v, 0, 0, 0, 0, 0, 0, 0) end
          obj_free(1)
        end
    """,
}


def _run(lua_mod, path, ticks=4):
    rec = RecordingAPI()
    script = lua_mod.LuaScript(rec, path)
    for k in range(ticks):
        script.on_tick(0.25 + k / 60, 1 / 60)
    plain = {k: v for k, v in script.interp.g.items()
             if isinstance(v, (bool, float, str))}
    return rec.calls, plain


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax_luamini(name, tmp_path):
    path = tmp_path / f"{name}.lua"
    path.write_text(SCRIPTS[name])
    got = _run(luamini, str(path))
    want = _run(jax_luamini, str(path))
    assert got == want
    assert got[0], "the script made no API call"
    for _, args in got[0]:
        assert all(not isinstance(a, float) or math.isfinite(a)
                   for a in args)


@pytest.mark.parametrize("src", ["x = 1",
                                 "function on_tick() x = nil + 1 end"],
                         ids=["no_on_tick", "on_tick_fails"])
def test_script_errors_match(src, tmp_path):
    path = tmp_path / "bad.lua"
    path.write_text(src)
    for lua_mod, api_mod in ((luamini, api), (jax_luamini, jax_api)):
        with pytest.raises(api_mod.ScriptError):
            lua_mod.LuaScript(RecordingAPI(), str(path)).on_tick(0.0, 0.0)
