"""What the benchmark loads, and what its files name (CPU only).

Each import check runs in a fresh interpreter, so that what this test
process has loaded does not count.  Top-level module names are compared
whole: pwnfps_tpu_torch begins with pwnfps_tpu and is not the JAX
package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE = [
    "portbench.reference", "portbench.reference.pixels",
    "portbench.reference.worlds.level", "portbench.reference.core.approx",
    "portbench.reference.core.config", "portbench.reference.core.detmath",
    "portbench.reference.core.ieee", "portbench.reference.core.lcg",
    "portbench.reference.ops.tracer_core", "portbench.reference.ops.vec",
    "portbench.reference.ops.world", "portbench.reference.ops.worlddev",
    "portbench.reference.render.camera", "portbench.reference.render.frame",
    "portbench.reference.world.cells", "portbench.reference.world.levelc",
    "portbench.reference.world.objects"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _loaded_after(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after
    running code from the repository's root."""
    probe = (code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    """The harness, its run entry, the control, every traffic kind a
    cell names, every metric reader and the reference, imported
    together, then the program's world built and a frame rendered on the
    CPU: no jax, jaxlib, flax or pwnfps_tpu module is loaded."""
    bench = _bench()
    kinds = set()
    for w in bench["workloads"]:
        _, _, _, traffic = harness.load_cell(ROOT, w["name"])
        kinds.add(traffic["kind"])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    code = "\n".join(
        ["import portbench.run, portbench.control, portbench.harness as h"]
        + [f"import portbench.traffic.{k}" for k in sorted(kinds)]
        + [f"import {m}" for m in REFERENCE]
        + [f"h.metric_reader({m!r})" for m in metrics]
        + ["h.run_cell('flagship-1080p', 5, 0.0, False, device='cpu', "
           "root='.', overrides=dict(width=16, height=8, warmup_steps=1), "
           "min_steps=2, log=lambda *a, **k: None)"])
    loaded = _loaded_after(code)
    assert "pwnfps_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("\n".join(f"import {m}" for m in REFERENCE))
    assert not loaded & {"pwnfps_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pwnfps_tpu_torch._probe", sys)
    assert "pwnfps_tpu_torch._probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pwnfps_tpu._probe", sys)
    assert "pwnfps_tpu._probe" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    """Without CUDA the entry prints no result and exits 2."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flagship-1080p",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_cells_name_files_that_exist():
    """Every cell's configuration and traffic mix is a file of its own
    under portbench/, whose traffic kind is a module there; every
    configuration's file is named in BENCHMARK.json."""
    bench = _bench()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        _, cell, config, traffic = harness.load_cell(ROOT, w["name"])
        assert config["name"] == cell["config"]
        assert os.path.exists(os.path.join(ROOT, files[cell["config"]]))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{traffic['kind']}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "worlds", f"{config['world']}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "reference", "worlds",
            f"{config['world']}.py"))
