"""Run ``chip_smoke.py``'s phase 20g at a depth of one's choosing, with
every check and reading of the phase.

The phase trains the study's model on the JAX package's recorded
simulation under ``reports/`` and runs its HMC stages 3b / 3c through the
fused kernels (``chip_smoke.phase_recorded_study``); ``check_sampler``
prints, for each stage, the z-gradient of the data term through the
kernels against the plain route in float64 (normwise / 99th percentile),
and, where either reading misses its limit, the plain float32 route's
beside it.  This reads a depth the script itself does not run, e.g. the
one at which a check missed.  Builds the kernels first, as the script
does.  Exits 1 where a check fails (its readings printed before).

    python3 tools/recorded_study_check.py --epochs 75 --steps 40 60

Needs the card.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None):
    import chip_smoke as cs

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=None, help="default: the script's")
    p.add_argument("--steps", type=int, nargs=2, default=None,
                   help="HMC steps of stages 3b and 3c (default: the script's)")
    args = p.parse_args(argv)

    from vihds_tpu_torch.utils import resolve_device

    phase, report, spec, kind, epochs, steps = next(
        r for r in cs.RECORDED_STUDIES if r[0] == "20g")
    epochs = args.epochs if args.epochs is not None else epochs
    steps = tuple(args.steps) if args.steps is not None else steps
    device = resolve_device("cuda")
    cs.phase_card()
    cs.phase_build()
    print("phase %s at %d epochs and %d / %d HMC steps" % ((phase, epochs) + tuple(steps)))
    cs.phase_recorded_study(device, phase, report, spec, kind, epochs, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
