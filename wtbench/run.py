"""Run one cell of the benchmark once and print its result line.

    python3 wtbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, wtbench/ and the
program (wave_tracer_tpu_torch). --trace 0 prints the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a torch.profiler trace of
a window of its own. Needs an NVIDIA card: without one, or with fewer
cards than the cell asks for, it exits 2 and prints no result. The last
line of standard output is the result (JSON); the last lines of standard
error give each number compared with the reference beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# kernel and build caches at fixed paths inside the checkout; no library
# the program uses may load JAX behind it
CACHE = ROOT / "_wtbench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from wtbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips[args.workload]:
        print(f"needs {chips[args.workload]} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    cell = harness.load_cell(ROOT, args.workload)
    result, checks = harness.run(cell, args.seed, args.seconds, args.trace,
                                 "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"run: setup_s {result['metrics'].get('setup_s', {}).get('value')}"
          f" frames {result['attempted']} total_s "
          f"{time.perf_counter() - T_START:.1f} frame_s "
          f"{[round(x, 3) for x in result['frame_s']]}", file=sys.stderr)
    for name, v, limit in checks:
        print(f"check {name}: {v!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.line(result, checks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
