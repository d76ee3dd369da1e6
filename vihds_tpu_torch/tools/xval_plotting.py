"""Offline regeneration of the xval report figures from saved artifacts
(``tools/xval_plotting.py`` on the port): ``XvalMerge.load`` of a results
directory's ``xval_*`` set, then its six figure families as png and pdf
there and into its ``xval`` TensorBoard writer.

Where matplotlib, seaborn or tensorboard cannot be imported it stops first,
with the one line ``run_xval --figures`` says, naming the package.

Usage: python -m vihds_tpu_torch.tools.xval_plotting <results_dir> <spec.yaml>
"""

import os
import sys


def main(argv=None, device="cuda"):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``); ``device`` is
    unused (nothing runs on a device)."""
    from vihds_tpu_torch.config import Config, Trainer
    from vihds_tpu_torch.run_xval import check_figures, create_parser
    from vihds_tpu_torch.xval import XvalMerge

    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        print(__doc__)
        sys.exit(1)
    location, spec = argv[0], argv[1]
    check_figures()

    args = create_parser(True).parse_args([spec])
    args.experiment = os.path.basename(location.rstrip("/"))
    args.seed = 0
    settings = Config(args)
    settings.trainer = Trainer(args, log_dir=location)
    xm = XvalMerge(args, settings)
    xm.load(location)
    xm.make_writer(location)
    xm.make_images()
    xm.close_writer()
    print("figures regenerated in %s" % location)


if __name__ == "__main__":
    main()
