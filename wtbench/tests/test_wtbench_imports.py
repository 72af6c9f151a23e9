"""Nothing the command imports, in its own process, is JAX or the JAX
package (compared by whole top-level names: the program's own name
starts with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

PROBE = r"""
import sys
sys.argv = ["wtbench/run.py"]
sys.path.insert(0, {repo!r})
import runpy
run = runpy.run_path({repo!r} + "/wtbench/run.py", run_name="probe")
from pathlib import Path
from wtbench import harness, check, control, record, readers, roofline, trace
from wtbench.reference import cones, edges, film, rays, utd
import json
root = Path({repo!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    cell = harness.load_cell(root, w["name"])
    cell.builder.scene(cell.config, dict(cell.traffic, resolution=8))
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene.build import build_scene
record.Recorder({{"k1": 1}}, 0, "cpu", ["k1"]).install()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "wave_tracer_tpu")]
print("BAD", bad)
assert "wave_tracer_tpu_torch" in sys.modules
"""


def test_command_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


def test_reference_loads_none_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r});"
            "import wtbench.reference.cones, wtbench.reference.edges,"
            "wtbench.reference.film, wtbench.reference.rays,"
            "wtbench.reference.utd, wtbench.geometry;"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'wave_tracer_tpu', "
            "'wave_tracer_tpu_torch')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    from wtbench import harness
    sys.modules.setdefault("wave_tracer_tpu_torch_probe", sys)
    try:
        assert "wave_tracer_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["wave_tracer_tpu_torch_probe"]
