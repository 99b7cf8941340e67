"""The readings that the limits of ``correct`` are set from, on the card:

    python benchmark/calibrate.py --workload fit512_b16.mean --seconds 2 \\
        --seeds 11 12 13 ...

For each seed, one run of the cell with a short window (the timed path as
a benchmark run drives it, at the cell's own sizes) and its numbers
against the plain reference: the program's readings. Then, on the same
inputs, the control, the plain reference computed one precision lower
(bfloat16) in the program's place, judged by the same comparison: its
readings. A line of JSON per seed, and last the largest program reading
and the smallest control reading of each number. Not part of a benchmark
run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def calibrate(workload, seeds, seconds, *, device="cuda", config_override=None,
              out=print):
    """``{number: (largest program reading, smallest control reading)}``
    over ``seeds``, printing each seed's line through ``out``."""
    rows = []
    for seed in seeds:
        got = {}

        def hook(job, numbers):
            got["program"] = numbers
            got["control"] = job.check(job.control())

        result = harness.run_cell(workload, seed, seconds, False,
                                  t_start=time.perf_counter(), device=device,
                                  config_override=config_override,
                                  after_check=hook)
        got.update(seed=seed, attempted=result["attempted"],
                   metrics={k: v["value"] for k, v in result["metrics"].items()})
        out(json.dumps(got))
        rows.append(got)
    names = rows[0]["program"].keys()
    return {k: (max(r["program"][k] for r in rows),
                min(r["control"][k] for r in rows)) for k in names}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    summary = calibrate(args.workload, args.seeds, args.seconds)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "program_max_control_min": summary}), flush=True)


if __name__ == "__main__":
    main()
