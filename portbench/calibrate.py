"""The readings a cell's correctness limits are set from (on the card).

    python3 portbench/calibrate.py --workload <cell> --seeds S1 S2 ... \\
        [--control-seeds S1 S2 S3] [--fault-seeds S1 S2 S3] [--seconds 1] [--out FILE]

For each of ``--seeds``, one run of the cell at its own size with a short
window: its numbers against the float64 reference (the lower readings).
For each of ``--control-seeds`` also the control's numbers: the reference in
float32 with TF32 matrix products put in the program's place (the upper
readings).  On a training cell, for each of ``--fault-seeds``, the program
with half of each fold's batch left out of the loss (the mean taken over the
rest), planted under the step the window drives.  One JSON line per
reading, to standard output and to ``--out``.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def half_batch():
    """Plant the half-batch fault: the loss of each fold over the first
    half of its rows only."""
    from vihds_tpu_torch import xfold

    original = xfold.loss_fn

    def loss_fn(model, program, params, batch, mask, u, folds=None):
        m = mask.clone().reshape(folds, -1)
        m[:, m.shape[1] // 2:] = 0.0
        return original(model, program, params, batch, m.reshape(-1), u, folds=folds)

    xfold.loss_fn = loss_fn
    try:
        yield
    finally:
        xfold.loss_fn = original


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    runs = [("program", s) for s in args.seeds] + [("fault_half_batch", s)
                                                   for s in args.fault_seeds]
    for what, seed in runs:
        control = what == "program" and seed in args.control_seeds
        ctx = half_batch() if what == "fault_half_batch" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            result, lines = harness.run_cell(args.workload, seed, args.seconds, 0, t0,
                                             control=control)
        line = {"cell": args.workload, "what": what, "seed": seed,
                "numbers": {k: v for k, v in result["check_detail"].items()
                            if isinstance(v, float)},
                "detail": {k: v for k, v in result["check_detail"].items()
                           if not isinstance(v, float)},
                "correct": result["correct"], "metrics": result["metrics"],
                "wall_s": time.perf_counter() - t0}
        if control:
            line["control"] = result["control"]
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
