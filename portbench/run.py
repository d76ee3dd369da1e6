"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each number
compared beside its limit), and those numbers as the last lines of standard
error.  With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.  Exits non-zero, printing no result, where
no card is visible, where the program is missing, or where JAX or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import torch

        from portbench import harness, manifest

        man = manifest.load(ROOT)
        chips = [w["chips"] for w in man["workloads"] if w["name"] == args.workload]
        import vihds_tpu_torch  # noqa: F401  (the system under test)
    except (ImportError, OSError, ValueError) as e:
        print("portbench: cannot start: %s" % e, file=sys.stderr)
        return 2
    if not chips:
        print("portbench: no cell %r in BENCHMARK.json" % args.workload, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]:
        print("portbench: the cell needs %d CUDA device(s); %s visible" % (
            chips[0], torch.cuda.device_count() if torch.cuda.is_available() else "none"),
            file=sys.stderr)
        return 3
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                                     T_START, device="cuda", root=ROOT)
    if not harness.jax_free():
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    for name, line in lines.items():
        print("check %s %r limit %r" % (name, line["value"], line["limit"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
