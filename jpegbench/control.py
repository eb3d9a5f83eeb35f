"""The control of `correct`: the program with its lower-precision colour.

    python3 jpegbench/control.py --workload rst444.loader128 \\
        --seeds 11 12 13 --seconds 10

A strict decode (the configuration's `strict: true`) is exact to the
plain reference.  The program's own lower-precision path, `strict=False`
(float32 colour where the contract computes in float64), is the step a
later change would be tempted to take; it has to come out as not
correct.  For each seed this runs the cell as the benchmark does, at the
cell's own size and load, with `strict` switched off, and prints the
numbers compared (one JSON line a seed).  The benchmark's own runs never
run this.
"""

import copy
import json
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv: list[str]) -> int:
    import argparse

    from jpegbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_json(
        harness.BENCH / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(
        harness.BENCH / "traffic" / f"{cell['traffic']}.json")
    control = copy.deepcopy(config)
    control["decoder"]["strict"] = False
    failed_all = True
    for seed in args.seeds:
        res = harness.run_cell(cell, control, traffic, spec, seed,
                               args.seconds, False, "cuda",
                               time.perf_counter())
        failed_all &= not res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
