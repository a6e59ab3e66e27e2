#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place and computed in TF32 (the precision below the float32,
TF32-off, that the configurations state), judged as the program's answers
are, against the reference in float32.

    python3 port_bench/control.py --workload inception_v3-f32.batch32-c16 \\
        --seeds 1,2,3

For each seed: the cell's weights and photo pool, every photo's top-k
answer from the TF32 reference, and the numbers the benchmark compares,
judged by the benchmark's own comparison (``judge.checks`` against the
configuration's limits, ``judge.passed``): one JSON line a seed, with its
``checks`` table and ``correct``. The control has to come out as not
correct: the script exits 1 if any seed's does not. The benchmark's own
runs never run this; it sets the upper reading of each limit. On a machine without a card, TF32 is
emulated by rounding every conv's and matmul's operands to its 10-bit
mantissa.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from yardstick import cells, judge, photos, reference, weights  # noqa: E402


def control_checks(cell: cells.Cell, seed: int, device: str) -> dict:
    """The control's ``checks`` table, as a run builds its own: every call
    answered (the control answers every photo), whole answers, and its
    gaps against the configuration's limits."""
    numbers = {**control_gaps(cell, seed, device), "failed_calls": 0, "malformed": 0}
    return judge.checks(numbers, {"failed_calls": 0, "malformed": 0, **cell.config["correct"]})


def control_gaps(cell: cells.Cell, seed: int, device: str) -> dict:
    cfg = cell.config
    params = weights.make_weights(cfg["arch"], seed, cfg["weights"], cfg["width"],
                                  cfg["classes"])
    jpegs = [p.jpeg for p in photos.make_pool(cell.traffic, seed)]
    kw = dict(width=cfg["width"], classes=cfg["classes"], mode=cfg["preprocess"],
              device=device)
    ref = reference.probabilities(cfg["arch"], params, jpegs, **kw)
    low = reference.probabilities(cfg["arch"], params, jpegs, precision="tf32", **kw)
    idx, scores = judge.topk(low, cfg["topk"])
    # the served scores are float32 probabilities
    return judge.gaps(np.arange(len(jpegs)), idx, scores.astype(np.float32).astype(np.float64),
                      ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default=None, help="default: the configuration's")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        table = control_checks(cell, seed, args.device or cell.config["device"])
        passed.append(judge.passed(table))
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": passed[-1],
                          "checks": table, "seconds": time.perf_counter() - t}), flush=True)
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
