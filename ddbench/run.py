"""The benchmark of ddo_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 ddbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  Set-up
imports the port, builds its two CUDA kernels on a checkout's first run
(into `ddo_tpu_torch/build/`, inside the checkout) and solves one
instance from outside the measured stream; the window then solves
instances drawn from the seed one after another for `--seconds` (see
`cell.py`).  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`),
`device` and, traced, `breakdown`; `checks`, the numbers compared with
the reference beside their limits, comes last, and standard error ends
with the same numbers.  Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell asks for), without the port
beside this folder, or when the process holds jax, jaxlib, flax or
ddo_tpu once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(code: int, message: str) -> int:
    print(f"ddbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        return fail(2, "--seconds must be above 0")
    if not os.path.isdir(os.path.join(ROOT, "ddo_tpu_torch")):
        return fail(2, f"the port ddo_tpu_torch is not beside ddbench/ in {ROOT}")

    import torch

    from ddbench import cell as cells

    cell = cells.Cell(args.workload)
    if not torch.cuda.is_available():
        return fail(3, "no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return fail(3, f"{cell.name} needs {cell.chips} GPUs, "
                       f"{torch.cuda.device_count()} present")
    result, lines = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   device="cuda", t0=T0)
    found = cells.forbidden_modules()
    if found:
        return fail(4, f"the process holds {', '.join(found)}")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout's root, not this folder
    sys.exit(main(sys.argv[1:]))
