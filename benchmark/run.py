"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (a profiled sub-window after the window).  Every run
judges a seeded sample of its served requests against the plain reference
and prints each number compared beside its limit, last on standard error
and under ``checks`` at the end of the result.  Exits non-zero, printing no
result, without CUDA or enough cards, or if JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import harness

    cell = harness.Cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.w["chips"]:
        print(f"needs {cell.w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the benchmark and the port must not load "
              f"JAX or the JAX package)", file=sys.stderr)
        return 3
    info = res.pop("_log")
    lat = sorted(res["metrics"].items())
    harness.log(f"setup {json.dumps(info['setup'])}; calibration {json.dumps(info['calibration'])}")
    harness.log(f"requests in the window {info['requests_in_window']}; judged {info['sample']} "
                f"in {info['judge_s']:.2f} s: {json.dumps(info['judged'])}")
    for k, v in lat:
        harness.log(f"metric {k} = {v['value']!r} {v['unit']}")
    for k, c in res["checks"].items():
        harness.log(f"check {k} = {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
