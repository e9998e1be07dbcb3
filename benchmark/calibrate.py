"""The readings a cell's limits are set from: the program and the control.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 [--out FILE]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the compared numbers twice, once of the program's answers
(the lower readings) and once of the control's: the reference itself in the
program's place, computed one precision below what the configuration
states: TF32 for the float32 convs, bfloat16 for the float32 log-VQT, whose
convs TF32 leaves as they are. A limit lies between the largest
lower and the smallest upper reading. The benchmark's own runs never run
the control. One JSON line a seed, and a summary, on standard output and,
with ``--out``, appended to that file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One seed's program and control readings for ``cell``."""
    import torch

    from benchmark import harness

    t0 = time.perf_counter()
    run = cell.driver.Run(cell.config, cell.traffic, seed, device)
    setup_s = time.perf_counter() - t0
    run.window(seconds, harness.Spans(False))
    run.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    line = {"seed": seed, "setup_s": setup_s, "attempted": run.attempted, "program": run.readings()}
    # The program's three leaves farthest from the reference, where the cell's driver names them.
    line["worst_leaves"] = getattr(run, "worst_leaves", None)
    line["control"] = run.readings(control=True)
    del run
    gc.collect()
    return line


def _emit(line: dict, out: str | None) -> None:
    print(json.dumps(line), flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(json.dumps(line) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", help="a file to append the JSON lines to")
    args = ap.parse_args(argv)
    from benchmark import harness
    from benchmark.run import _environment

    _environment()
    cell = harness.Cell(args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        lines.append(readings(cell, seed, args.seconds))
        _emit(lines[-1], args.out)
    names = sorted(lines[0]["program"])
    _emit({"summary": args.workload,
           "lower": {n: max(ln["program"][n] for ln in lines) for n in names},
           "upper": {n: min(ln["control"][n] for ln in lines) for n in names}}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
