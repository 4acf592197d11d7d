"""The control of `correct`: the family's reference put in the program's
place with one guarantee broken, judged by the same comparison as a run.

    python3 ddbench/control.py --workload <cell> --seeds 1,2,3 --count <solves>

For each seed it draws the first `count` instances of the cell's measured
stream, as a run of that seed does, answers each with the reference's
`control` (a restricted DP that keeps a few labels per layer and reports
its best as the proved optimum: a search that skips its proof) and prints
the compared numbers beside their limits.  The control has to come out
not correct on every seed.  It needs no device; the benchmark's own runs
never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_records(cell, instances):
    records = []
    for inst in instances:
        value, vals, pset = cell.ref.control(inst)
        records.append({"objective": value, "lower": value, "upper": value,
                        "exact": True, "vals": vals, "pset": pset})
    return records


def main(argv) -> int:
    from ddbench import cell as cells, judge

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--count", type=int, required=True)
    args = p.parse_args(argv)
    cell = cells.Cell(args.workload)
    all_failed = True
    for seed in (int(s) for s in args.seeds.split(",")):
        insts = [cell.instance(seed, cells.MEASURED, i) for i in range(args.count)]
        verdict = judge.judge(control_records(cell, insts), insts, cell.ref)
        ok = judge.correct(verdict["counts"])
        all_failed &= not ok
        print(json.dumps({"workload": cell.name, "seed": seed, "count": args.count,
                          "correct": ok, "counts": verdict["counts"]}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout's root, not this folder
    sys.exit(main(sys.argv[1:]))
