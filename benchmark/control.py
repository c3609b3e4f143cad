"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size, in one process: the program's numbers on many seeds (the
lower readings), the control's (the reference computed in float8 in the
program's place: the upper readings), and each planted fault's.  Each run
is the cell's own run (set-up, a short window at the cell's load, the
judged sample); one JSON line a run goes to ``--out``.  The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload flagship-tiles-b64 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 --out chiprun_out/c.jsonl
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    import harness
    from faults import FAULTS

    ints = lambda s: [int(v) for v in s.split(",") if v]
    plan = [("program", s, None, False) for s in ints(a.seeds)]
    plan += [("control", s, None, True) for s in ints(a.control_seeds)]
    plan += [(name, s, f, False) for s in ints(a.fault_seeds) for name, f in FAULTS.items()]
    with open(a.out, "a") as out:
        for kind, seed, fault, control in plan:
            t = time.perf_counter()
            res = harness.run_cell(ROOT, a.workload, seed, a.seconds, False, plant=fault,
                                   control=control)
            row = {"workload": a.workload, "kind": kind, "seed": seed,
                   "correct": res["correct"], "judged": res["_log"]["judged"],
                   "checks": res["checks"], "setup": res["_log"]["setup"],
                   "calibration": res["_log"]["calibration"], "seconds": time.perf_counter() - t}
            out.write(json.dumps(row) + "\n")
            out.flush()
            worst = {k: round(v["value"], 6) for k, v in res["checks"].items()}
            print(f"{a.workload} {kind} seed {seed}: {worst} correct {res['correct']}",
                  flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
