"""The readings that the limits of `correct` are set from.

    python3 wtbench/control.py --workload <name> --seeds <a>-<b> \
        [--control-seeds <n>] [--out <file.json>]

Sets the cell up once, then for each seed runs the shortest window that
records its checked frame (its `min_frames` frames) and judges it: the
program's numbers on every seed (the lower readings are their largest),
and on the first --control-seeds seeds also the control's, the plain
reference computed in TF32 in the program's place (the upper readings
are their smallest). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last, inclusive")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from wtbench import harness

    lo, hi = (int(x) for x in args.seeds.split("-"))
    cell = harness.load_cell(Path.cwd(), args.workload)
    prog = harness.Program(cell, args.device)
    prog.frame(lo, -1)
    rows = []
    for i, seed in enumerate(range(lo, hi + 1)):
        t0 = time.perf_counter()
        win = harness.window(prog, seed, 0.0)
        row = dict(seed=seed, frames=win.frames,
                   program=harness.judge(cell, win, args.device))
        if i < args.control_seeds:
            row["control"] = harness.judge(cell, win, args.device,
                                           control=True)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    names = list(rows[0]["program"])
    summary = dict(
        workload=args.workload,
        lower={n: max(r["program"][n] for r in rows) for n in names},
        upper={n: min(r["control"][n] for r in rows if "control" in r)
               for n in names if any("control" in r for r in rows)})
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(rows=rows, **summary),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
