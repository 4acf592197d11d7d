"""The comparison that decides `correct`: every solve of the window against
the family's plain reference, worked out again from the same arrays.

For each solve the program hands back its objective, its bounds, whether
it proved them, and its solution.  Three numbers are compared, each a
count of solves over the window, each with the limit 0 (an exact
comparison):

  * `wrong_value`: a proved objective that is not the reference's
    optimum, or an unproved one above it;
  * `bad_bounds`: a proved solve whose lower and upper bounds are not both
    the optimum, or an unproved one whose bounds do not bracket it;
  * `bad_solution`: a solution that does not replay (an item or a position
    left undecided, a capacity or a window broken, a tour that is no
    tour) to the objective it came with, or no solution beside an
    objective.

A solve that ends unproved (its cutoff fired) is late, not wrong: it
counts as failed, and is held to the bracket and its replay.
"""

from __future__ import annotations

LIMITS = {"wrong_value": 0, "bad_bounds": 0, "bad_solution": 0}


def judge(records, instances, ref) -> dict:
    """{"counts": {name: count}, "failed": solves failed, "wrong":
    indices judged wrong}.  `records[i]` is solve i's dict (`objective`,
    `lower`, `upper`, `exact`, `vals`, `pset`), `instances[i]` its arrays,
    `ref` the family's reference module (`optimum`, `replay`)."""
    counts = dict.fromkeys(LIMITS, 0)
    wrong, failed = [], 0
    for i, (rec, inst) in enumerate(zip(records, instances)):
        opt = ref.optimum(inst)
        obj, lo, up = rec["objective"], rec["lower"], rec["upper"]
        if rec["exact"]:
            bad_value = obj != opt
            bad_bounds = opt is not None and not lo == up == opt
        else:
            bad_value = obj is not None and (opt is None or obj > opt)
            bad_bounds = opt is not None and not lo <= opt <= up
        if obj is None:
            bad_sol = rec["vals"] is not None
        else:
            bad_sol = rec["vals"] is None or ref.replay(inst, rec["vals"], rec["pset"]) != obj
        for name, bad in (("wrong_value", bad_value), ("bad_bounds", bad_bounds),
                          ("bad_solution", bad_sol)):
            counts[name] += bool(bad)
        if bad_value or bad_bounds or bad_sol:
            wrong.append(i)
        if bad_value or bad_bounds or bad_sol or not rec["exact"]:
            failed += 1
    return {"counts": counts, "failed": failed, "wrong": wrong}


def correct(counts) -> bool:
    return all(counts[name] <= limit for name, limit in LIMITS.items())


def lines(counts, judged: int):
    """The compared numbers beside their limits, one short line each."""
    out = [f"judged {judged} solves against the reference"]
    out += [f"{name} {counts[name]} limit {limit}" for name, limit in LIMITS.items()]
    return out
