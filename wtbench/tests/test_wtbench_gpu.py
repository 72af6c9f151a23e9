"""The benchmark's cells on the card: one short run of each, correct and
with the card named in the result. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(w):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "wtbench/run.py", "--workload", w,
                          "--seed", str(2 ** 31 + 5), "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
