"""k-fold cross-validation: train every split in turn and merge them.

The port's ``python -m vihds_tpu.call_run_xval``, with the same flags::

  python -m vihds_tpu_torch.call_run_xval specs/dr_constant_icml.yaml \\
      --experiment X --epochs 1000 --test_epoch 20 --folds 4

It runs ``run_xval.run_on_split`` on folds 1 .. ``--folds`` (with
``--vmap_folds``, all folds in one batched step: ``xfold.run_all_folds``,
which falls back to the fold loop, saying why, where the batched run cannot
express the configuration), adds each fold's
best-validation results to one ``XvalMerge`` and writes the merged
``xval_*`` set, the xval figures (png, pdf and the ``xval/`` event files,
as the JAX package always does) and ``completed.txt`` under
``$INFERENCE_RESULTS_DIR/<experiment>_<time>/``, beside each fold's
``.vihds_cache_<fold>_of_<folds>`` and TensorBoard event files.  Where
matplotlib, seaborn or tensorboard is not installed, the figures are left
out (said once) and the rest is written.  It trains on the CUDA device
unless ``main`` is given ``device="cpu"``.

The meshes and the multi-process launch take ``run_xval``'s flags
(``--distributed``, ``--mesh``, ``--mesh_data``, ``--mesh_sample``): each
fold trains over the ranks' (data, sample) mesh, rank 0 writes.  Over
several processes ``--vmap_folds`` takes the fold loop; in one process,
``--vmap_folds --mesh auto`` spreads the folds over the local cards
(``xfold.make_fold_mesh``).
"""

from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.parallel import multihost
from vihds_tpu_torch.run_xval import create_parser, run_on_split, write_figures
from vihds_tpu_torch.utils import FIGURE_PACKAGES, missing_packages, note_once, resolve_device
from vihds_tpu_torch.xval import XvalMerge


def execute(args, settings, device="cuda"):
    """Train folds 1 .. ``args.folds`` (one after another, or with
    ``args.vmap_folds`` all in one batched step) and write the merged
    artifacts (where ``settings.trainer`` is set: not on the other ranks of a
    ``--distributed`` launch); returns the ``XvalMerge`` (None when no fold
    left results)."""
    xval_merge = XvalMerge(args, settings)
    fold_results = None
    if getattr(args, "vmap_folds", False):
        from vihds_tpu_torch import xfold

        fold_results = xfold.run_all_folds(args, settings, device=device)
    if fold_results is not None:
        for split_idx, data_pair, val_results in fold_results:
            if val_results is not None:
                xval_merge.add(split_idx, data_pair, val_results)
    else:
        for split_idx in range(1, args.folds + 1):
            print("================================================================")
            print("    FOLD %d of %d" % (split_idx, args.folds))
            print("---------------------------")
            data_pair, val_results, _ = run_on_split(args, settings, split=split_idx,
                                                     device=device)
            if val_results is not None:
                xval_merge.add(split_idx, data_pair, val_results)
    print("================================================================")
    if len(xval_merge.elbo) == 0:
        print("No results in xval. Exiting...")
        return None
    if settings.trainer is None:
        return xval_merge
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
    device = resolve_device(device)
    process_count, rank, device = multihost.initialize_from_args(args, device)
    try:
        if process_count > 1 and getattr(args, "vmap_folds", False):
            # the batched folds run in one process; over several, every rank
            # takes the fold loop on the ranks' mesh (the same decision on
            # every rank: lockstep)
            print("--vmap_folds is single-process; using the sequential driver")
            args.vmap_folds = False
        settings = Config(args)
        settings.trainer = Trainer(args, add_timestamp=True) if rank == 0 else None
        return execute(args, settings, device=device)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
