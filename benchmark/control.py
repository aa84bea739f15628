"""The readings a cell's limits are set from, in one process on the card:
the program's runs on `--seeds` seeds (the lower reading: the most
`words_wrong` a sound run gives) and the control's on `--control-seeds`
(the upper reading: the least the reference computed in float64 in the
program's place gives), each a short window at the cell's own size.  The
benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 3

One JSON line a run, then one with both readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    args = ap.parse_args(argv)

    from benchmark import cells, run

    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = cells.cell(args.workload)
    readings = {"program": [], "control": []}
    seed = args.first_seed
    for system, count in (("program", args.seeds), ("control", args.control_seeds)):
        for _ in range(count):
            seed += 1
            res = run.run(cell, seed, args.seconds, False, device, system=system,
                          t_start=time.perf_counter())
            wrong = res["checks"]["words_wrong"]["value"]
            readings[system].append(wrong)
            print(json.dumps({"workload": args.workload, "system": system, "seed": seed,
                              "correct": res["correct"], "words_wrong": wrong,
                              "attempted": res["attempted"], "metrics": res["metrics"]}))
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": run.card_line(),
                      "lower": max(readings["program"]), "upper": min(readings["control"]),
                      "limit": run.LIMITS["words_wrong"], "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
