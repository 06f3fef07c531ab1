"""Read a cell's compared numbers and its control's, on many seeds in one
process (the readings that the limits in ``checks/<cell>.json`` are set
from).  The benchmark's own runs never run the control.

    python -m portbench.readings --workload <cell> --seeds 1,2,3 --seconds 20

Each seed is a whole run of the cell (its inputs, a short window at the
cell's own load, the check), and the control, the reference put in the
program's place one precision lower (``check.control_bits``), judged on the
same asks by the same limits.  Prints one JSON line a seed: the program's
numbers and ``correct``, and the control's, which has to come out false.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run  # sets the cache directories first
from portbench.check import control_bits
from portbench.registry import find_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("portbench.readings: no CUDA card visible")
        return 3
    cell = find_cell(args.workload)
    bits = control_bits(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False, control=bits,
                           t_start=run.perf_counter())
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "checks": res["checks"], "control": res["_control"],
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
