"""k-fold cross-validation: train every split in turn and merge them.

The port's ``python -m vihds_tpu.call_run_xval``, with the same flags::

  python -m vihds_tpu_torch.call_run_xval specs/dr_constant_icml.yaml \\
      --experiment X --epochs 1000 --test_epoch 20 --folds 4

It runs ``run_xval.run_on_split`` on folds 1 .. ``--folds``, adds each fold's
best-validation results to one ``XvalMerge`` and writes the merged
``xval_*`` set, the xval figures (png, pdf and the ``xval/`` event files,
as the JAX package always does) and ``completed.txt`` under
``$INFERENCE_RESULTS_DIR/<experiment>_<time>/``, beside each fold's
``.vihds_cache_<fold>_of_<folds>`` and TensorBoard event files.  Where
matplotlib, seaborn or tensorboard is not installed, the figures are left
out (said once) and the rest is written.  It trains on the CUDA device
unless ``main`` is given ``device="cpu"``.

Not ported yet, each waiting for its ROADMAP item: all folds as one batched
program (``--vmap_folds``, "xfold.py") and the multi-process launch
("parallel/ + parallel/multihost.py").  Their flags stop the run with a
one-line error, as in ``run_xval``.
"""

from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.run_xval import check_ported, create_parser, run_on_split, write_figures
from vihds_tpu_torch.utils import FIGURE_PACKAGES, missing_packages, note_once, resolve_device
from vihds_tpu_torch.xval import XvalMerge


def execute(args, settings, device="cuda"):
    """Train folds 1 .. ``args.folds`` one after another and write the
    merged artifacts; returns the ``XvalMerge`` (None when no fold left
    results)."""
    xval_merge = XvalMerge(args, settings)
    for split_idx in range(1, args.folds + 1):
        print("================================================================")
        print("    FOLD %d of %d" % (split_idx, args.folds))
        print("---------------------------")
        data_pair, val_results, _ = run_on_split(args, settings, split=split_idx, device=device)
        if val_results is not None:
            xval_merge.add(split_idx, data_pair, val_results)
    print("================================================================")
    if len(xval_merge.elbo) == 0:
        print("No results in xval. Exiting...")
        return None
    xval_merge.finalize()
    xval_merge.save()
    missing = missing_packages(FIGURE_PACKAGES)
    if missing:
        note_once("Figures off: the %s package is not installed" % missing[0])
    else:
        write_figures(xval_merge)
    xval_merge.mark_completed(args.experiment)
    print("Completed")
    return xval_merge


def main(argv=None, device="cuda"):
    args = create_parser(False).parse_args(argv)
    check_ported(args)
    device = resolve_device(device)
    settings = Config(args)
    settings.trainer = Trainer(args, add_timestamp=True)
    return execute(args, settings, device=device)


if __name__ == "__main__":
    main()
