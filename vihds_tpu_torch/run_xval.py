"""Single-split CLI: train one train/validation split of a spec.

The port's ``python -m vihds_tpu.run_xval``, with the same flags::

  python -m vihds_tpu_torch.run_xval specs/dr_constant_icml.yaml \\
      --experiment X --epochs 1000 --test_epoch 20

It writes the same artifacts under ``$INFERENCE_RESULTS_DIR/<experiment>_<time>/``:
the spec, the per-fold best-validation cache ``.vihds_cache_<split>``, the
``xval_*`` set and ``completed.txt``, the TensorBoard event files of the
split (``train_<split>/``, ``valid_<split>/``: scalars at every evaluation,
figures every ``--plot_epoch``); with ``--checkpoint_epoch N`` also
``checkpoints_<split>/``, with ``--figures`` the xval figures as png and pdf
and the ``xval/`` event files, with ``--profile_dir DIR`` one
``torch.profiler`` trace in DIR.  ``--dreg`` trains with the DReG gradient.
It trains on the CUDA device unless ``main`` or ``run_on_split`` is given
``device="cpu"``.  Where tensorboard or matplotlib is not installed, the
event files or figures are left out (said once) and the rest is written;
``--figures`` then stops before any training, naming the package.  Flags
whose feature the port does not have yet stop the run with a one-line error
that names its ROADMAP item.
"""

import argparse

from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.data.datasets import build_datasets
from vihds_tpu_torch.prob import ParamProgram, parse_parameters
from vihds_tpu_torch.training import Training
from vihds_tpu_torch.utils import FIGURE_PACKAGES, missing_packages, resolve_device
from vihds_tpu_torch.vae import VAE
from vihds_tpu_torch.xval import XvalMerge

#: flag -> (is it set?, the title of the ROADMAP item that ports it)
NOT_PORTED = {
    "--mesh": (lambda a: a.mesh != "off", "parallel/ + parallel/multihost.py"),
    "--mesh_data": (lambda a: a.mesh_data is not None, "parallel/ + parallel/multihost.py"),
    "--mesh_sample": (lambda a: a.mesh_sample is not None, "parallel/ + parallel/multihost.py"),
    "--distributed": (lambda a: a.distributed is not None, "parallel/ + parallel/multihost.py"),
    "--vmap_folds": (lambda a: a.vmap_folds, "xfold.py"),
}


def create_parser(with_split: bool):
    """The JAX package's ``run_xval`` flags."""
    parser = argparse.ArgumentParser(description="VI-HDS (PyTorch)")
    parser.add_argument("yaml", type=str, help="Name of yaml spec file")
    parser.add_argument(
        "--experiment", type=str, default="unnamed",
        help="Name for experiment, also location of saved results",
    )
    parser.add_argument("--seed", type=int, default=None, help="Random seed (default: 0)")
    parser.add_argument("--epochs", type=int, default=1000, help="Training epochs")
    parser.add_argument("--test_epoch", type=int, default=20, help="Frequency of calling test")
    parser.add_argument("--plot_epoch", type=int, default=100, help="Frequency of plotting figures")
    parser.add_argument(
        "--train_samples", type=int, default=200,
        help="Number of samples from q, per datapoint, during training",
    )
    parser.add_argument(
        "--test_samples", type=int, default=1000,
        help="Number of samples from q, per datapoint, during testing",
    )
    parser.add_argument("--dreg", action="store_true", default=False, help="Use DReG estimator")
    parser.add_argument(
        "--precision_hidden_layers", type=int, default=None,
        help="Number of hidden layers to use in neural precisions",
    )
    parser.add_argument(
        "--grad_clip_norm", type=float, default=None,
        help="Global-norm gradient clipping (params.grad_clip_norm override)",
    )
    parser.add_argument(
        "--q_global_init", type=str, default=None, choices=["prior", "unit"],
        help="Override the GLOBAL q-site precision init ('unit' = log-prec 0, "
        "'prior' = start q at the prior precision)",
    )
    parser.add_argument(
        "--verbose", action="store_true", default=False, help="Print more information"
    )
    parser.add_argument(
        "--gpu", type=int, default=None,
        help="Ignored (the device is the 'device' argument of main())",
    )
    parser.add_argument(
        "--checkpoint_epoch", type=int, default=0,
        help="Save a full training checkpoint (params+optimizer+RNG) every N epochs (0 = off)",
    )
    parser.add_argument(
        "--resume_from", type=str, default=None,
        help="Path to a checkpoints directory to resume training from",
    )
    parser.add_argument(
        "--profile_dir", type=str, default=None,
        help="Write a torch.profiler trace of the first epoch chunk after the start epoch "
        "into this directory",
    )
    parser.add_argument("--distributed", type=str, default=None, help="Not ported yet")
    parser.add_argument("--mesh", type=str, default="off", choices=["off", "auto"],
                        help="Not ported yet")
    parser.add_argument("--mesh_data", type=int, default=None, help="Not ported yet")
    parser.add_argument("--mesh_sample", type=int, default=None, help="Not ported yet")
    if with_split:
        group = parser.add_mutually_exclusive_group()
        group.add_argument("--heldout", type=str, help="name of held-out device, e.g. R33S32_Y81C76")
        group.add_argument(
            "--split", type=int, default=1, help="Specify split in 1:folds for cross-validation"
        )
        group.add_argument(
            "--figures", action="store_true", default=False, help="Create figures (default: False)"
        )
    parser.add_argument("--folds", type=int, default=4, help="Cross-validation folds")
    parser.add_argument("--vmap_folds", action="store_true", default=False, help="Not ported yet")
    parser.add_argument("--rerun_outliers", action="store_true", default=False,
                        help="(with --vmap_folds) not ported yet")
    parser.add_argument("--outlier_nats", type=float, default=50.0,
                        help="(with --vmap_folds) not ported yet")
    return parser


def not_ported(flag, item):
    """The one-line error of a flag whose feature waits for the ROADMAP item
    titled ``item``."""
    return SystemExit('%s is not ported to vihds_tpu_torch yet (ROADMAP queue 1, "%s")'
                      % (flag, item))


def check_ported(args):
    """Stop with a one-line error on a flag whose feature is not ported."""
    for flag, (is_set, item) in NOT_PORTED.items():
        if is_set(args):
            raise not_ported(flag, item)


def check_figures(packages=FIGURE_PACKAGES):
    """Stop, before any work, with a one-line error where one of the
    ``packages`` that ``--figures`` needs cannot be imported."""
    missing = missing_packages(packages)
    if missing:
        raise SystemExit("--figures needs the %s package, which is not installed" % missing[0])


def write_figures(xval_merge):
    """The xval figures as png / pdf and into the ``xval`` writer."""
    xval_merge.make_writer()
    xval_merge.make_images()
    xval_merge.close_writer()


def make_training(args, settings, split=None, device="cuda"):
    """The datasets of one train/validation split and the ``Training`` that
    trains on them, not yet run; returns (data pair, Training)."""
    device = resolve_device(device)
    if getattr(args, "heldout", None):
        print("Heldout device is %s" % args.heldout)
    else:
        args.heldout = None
        if split is not None:
            args.split = split
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    return data, Training(settings, data, program, model, args=args, device=device)


def run_on_split(args, settings, split=None, device="cuda"):
    """Train one train/validation split; returns (data pair, best-val Results
    or None, the Training that ran: its step times, ELBO lists and final
    params)."""
    data, training = make_training(args, settings, split=split, device=device)
    return data, training.run(), training


def save_xval(args, settings, data_pair, val_results):
    """Write the ``xval_*`` artifacts of the one trained split and
    ``completed.txt``; returns the ``XvalMerge``, or None when the run left
    no best-validation results."""
    if val_results is None:
        return None
    xval_merge = XvalMerge(args, settings)
    xval_merge.add(1, data_pair, val_results)
    xval_merge.finalize()
    xval_merge.save()
    xval_merge.mark_completed(args.experiment)
    return xval_merge


def main(argv=None, device="cuda"):
    args = create_parser(True).parse_args(argv)
    check_ported(args)
    if args.figures:
        check_figures()
    device = resolve_device(device)
    settings = Config(args)
    settings.trainer = Trainer(args, add_timestamp=True)
    data_pair, val_results, _ = run_on_split(args, settings, device=device)
    xval_merge = save_xval(args, settings, data_pair, val_results)
    if xval_merge is not None and args.figures:
        write_figures(xval_merge)


if __name__ == "__main__":
    main()
