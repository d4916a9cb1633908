"""Readings for the correctness limits, on the card: the program's numbers
on many seeds, and the control's on some, in one process.

    python3 benchmark/control.py --workload final.offline --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 10

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the check) and prints one JSON line: the numbers compared
and, for a control seed, the same numbers for the control, the reference
computed in bfloat16 (the precision below the configuration's float32)
put in the program's place on the same answers. The limits in
``benchmark/limits/`` lie between the program's largest reading and the
control's smallest. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import registry, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    reg = registry.Registry(run.ROOT)
    cell = reg.cell(args.workload)
    program = run.load_program()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, False, program, reg=reg,
                           control=seed in controls)
        line = {"workload": cell.name, "seed": seed, "correct": out["correct"],
                "attempted": out["attempted"], "reference_s": out["reference_s"],
                "program": {k: v["value"] for k, v in out["checks"].items()}}
        if "control_checks" in out:
            line["control"] = {k: v["value"] for k, v in out["control_checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
