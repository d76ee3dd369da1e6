"""Amortised posterior serving: predictions on unseen plate-reader data from
a trained checkpoint.

The serving path of ``vihds_tpu.predict`` in PyTorch: restore the params of a
checkpoint that ``run_xval --checkpoint_epoch N`` wrote, parse new CSVs with
the spec's device/treatment vocabulary, snap them onto the training time
grid, re-apply the training normalisation, and evaluate q(theta | x_new) ->
K theta draws -> the ODE decoder (the fused CUDA kernels under
``eval_solver: pallas_<method>``) -> IWAE-weighted posterior-predictive
moments, with no retraining.  ``--treatments`` re-simulates the inferred
posterior under counterfactual inputs.

CLI (on the CUDA device)::

  python -m vihds_tpu_torch.predict <spec.yaml> --checkpoint DIR --data NEW.csv \
      [--data MORE.csv ...] [--test_samples K] [--output out.npz] [--save_theta] \
      [--treatments "C6=25000;C12=0"] [--figures] [--precision_hidden_layers N] \
      [--distributed HOST:PORT,NPROC,PID --mesh_sample S]

The parser is ``run_xval``'s (without its split group) with the serving
flags added, as the JAX package's is, so the flags that shape a model
(``--precision_hidden_layers``, ``--q_global_init``) serve a checkpoint
trained with them.  Over several processes (``--distributed``, one command
per rank) the evaluation's decoder block shards over the mesh that
``--mesh auto`` / ``--mesh_data`` / ``--mesh_sample`` ask for
(``training.sharded_eval_step``); rank 0 alone writes the npz and the
figures.

``--figures`` also writes the prediction-summary figure beside the npz
(``out.png``, ``out.pdf``); it needs matplotlib and seaborn, and stops
before any work, naming the package, where one is not installed.

Library (``params`` in memory instead of a checkpoint, or neither and
``--checkpoint`` in ``args``)::

  from vihds_tpu_torch.predict import create_parser, predict, save_predictions
  args = create_parser().parse_args(["specs/dr_constant_icml.yaml",
                                     "--data", "data/proc141021.csv"])
  out = predict(args, params=params)            # device="cuda" by default
  save_predictions("predictions.npz", out, args, Config(args))

Reading the JAX package's orbax checkpoints is not part of the port: hand
JAX params to ``convert.params_from_jax`` and ``predict(params=...)``.
"""

import copy
import os

import numpy as np
import torch

from vihds_tpu_torch import checkpoint as ckpt
from vihds_tpu_torch import parallel, run_xval
from vihds_tpu_torch.config import Config
from vihds_tpu_torch.data import procdata
from vihds_tpu_torch.data.datasets import TimeSeriesDataset, build_datasets, find_nearest
from vihds_tpu_torch.parallel import multihost
from vihds_tpu_torch.prob import ParamProgram, parse_parameters
from vihds_tpu_torch.training import Training, _importance_weighted_outputs, batch_tensors
from vihds_tpu_torch.utils import resolve_device
from vihds_tpu_torch.utils.attrdict import AttrDict
from vihds_tpu_torch.vae import VAE, params_to


def create_parser():
    """The serving flags of ``vihds_tpu.predict``: ``run_xval``'s parser
    without its split group, the training split (``--split``,
    ``--heldout``) and the serving flags."""
    parser = run_xval.create_parser(False)
    parser.description = "VI-HDS serving (PyTorch)"
    parser.add_argument(
        "--checkpoint", type=str, default=None,
        help="Checkpoints directory of a trained run (run_xval --checkpoint_epoch N); "
        "required by the CLI",
    )
    parser.add_argument("--split", type=int, default=1, help="Split in 1:folds")
    parser.add_argument("--heldout", type=str, default=None, help="Held-out device name")
    parser.add_argument(
        "--data", type=str, action="append", required=True,
        help="CSV of new plate-reader time series (repeatable)",
    )
    parser.add_argument(
        "--output", type=str, default="predictions.npz",
        help="Output .npz path (default: ./predictions.npz)",
    )
    parser.add_argument(
        "--save_theta", action="store_true", default=False,
        help="Also store the per-sample theta draws [n_theta, B, K]",
    )
    parser.add_argument(
        "--figures", action="store_true", default=False,
        help="Render a prediction-summary figure next to the output npz",
    )
    parser.add_argument(
        "--treatments", type=str, action="append", default=None,
        help='Counterfactual treatment override, e.g. "C6=25000;C12=0" (repeatable)',
    )
    return parser


def load_new_data(csv_files, settings, train_dataset):
    """Parse new CSVs and express them in the trained model's coordinates:
    the training time grid (the encoder is shape-bound to it), the training
    per-signal scales, and the spec's device/treatment vocabulary.  Returns
    a host batch AttrDict of numpy arrays."""
    train_times = np.asarray(train_dataset.times)
    dt = float(np.median(np.diff(train_times)))
    parts = []
    for f in csv_files:
        # bare names resolve under the spec's data_dir; real paths pass through
        if os.path.exists(f):
            f = os.path.abspath(f)
        try:
            parsed = procdata.load(f, settings.data)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e)) from None
        if parsed is None:
            raise SystemExit(
                "No rows in %s match the spec's devices %s — predictions require "
                "devices the model was trained on" % (f, list(settings.data.devices))
            )
        devices, inputs, times, obs = parsed
        # nearest-time snap onto the training grid (the rule the merge uses)
        idx = np.array([find_nearest(times, t) for t in train_times])
        worst = float(np.max(np.abs(np.asarray(times)[idx] - train_times)))
        span = float(train_times[-1] - train_times[0])
        if worst > 0.25 * span:
            raise SystemExit(
                "Time grid of %s is incompatible with the training grid: the "
                "nearest available reading is %.2f time units away from some "
                "training timepoint (training grid spans [%g, %g], step %.2f)"
                % (f, worst, float(train_times[0]), float(train_times[-1]), dt)
            )
        if worst > 1.5 * dt:
            print(
                "WARNING: %s deviates up to %.2f time units from the training grid "
                "(grid step %.2f) — predictions interpolate by nearest time" % (f, worst, dt)
            )
        parts.append((devices, inputs, obs[:, :, idx]))

    ds_settings = copy.copy(settings.data)
    ds_settings.normalize = [float(s) for s in train_dataset.scales]
    ds = TimeSeriesDataset(ds_settings, settings.params)
    ds._preprocess(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        train_times,
        np.concatenate([p[2] for p in parts]),
    )
    return ds.select(np.arange(len(ds)))


def restore_params(directory):
    """(epoch, params) of the newest checkpoint under ``directory``, on the
    host.  Stops with a one-line error where ``directory`` is not a
    directory or holds no checkpoint; creates nothing."""
    if directory is None or not os.path.isdir(directory):
        raise SystemExit("No checkpoint found under %s (not a directory)" % directory)
    epoch, state = ckpt.restore(directory)
    if state is None:
        raise SystemExit("No checkpoint found under %s" % directory)
    return epoch, state["params"]


def predict(args, settings=None, params=None, device="cuda", generator=None):
    """Predict on the ``args.data`` CSVs with the trained ``params`` (a param
    dict as ``VAE.init_params`` or ``convert.params_from_jax`` make it) or,
    where ``params`` is None, with those of the newest checkpoint under
    ``args.checkpoint``.

    ``generator`` draws the K theta samples; by default a generator on
    ``device`` seeded from the spec seed.  Under an ambient mesh of several
    ranks (``parallel.use_mesh``) the evaluation shards its decoder block
    over them, every rank drawing the same samples.  Returns AttrDict(merged=<eval
    arrays>, results=<Results>, host=<input batch>, epoch=<the checkpoint's
    epoch, or -1 for params handed in>, scales, counterfactuals)."""
    device = resolve_device(device)
    epoch = -1
    if params is None:
        epoch, params = restore_params(args.checkpoint)
    if settings is None:
        settings = Config(args)
    settings.trainer = None
    if not getattr(args, "heldout", None):
        args.heldout = None
    if not hasattr(args, "split"):
        args.split = 1

    data = build_datasets(args, settings)
    full_dataset = data.train.dataset
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    training = Training(settings, data, program, model, mesh=parallel.active_mesh())
    params = params_to(params, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(settings.seed)

    host = load_new_data(args.data, settings, full_dataset)
    if training.multi:
        # a model trained on merge: false data encodes enc_observations; new
        # data already lies on the encoder's (shortest) grid
        host["enc_observations"] = host.observations
    treatments = getattr(args, "treatments", None) or []
    merged, results = training.evaluate(
        params, host, args.test_samples, generator, device,
        with_theta=getattr(args, "save_theta", False) or bool(treatments),
    )
    counterfactuals = [
        counterfactual(training, params, host, merged, spec_str, device)
        for spec_str in treatments
    ]
    return AttrDict(
        merged=merged,
        results=results,
        host=host,
        epoch=epoch,
        scales=[float(s) for s in full_dataset.scales],
        counterfactuals=counterfactuals,
    )


def counterfactual(training, params, host, merged, treatment_spec, device="cuda"):
    """Re-simulate the inferred posterior theta under overridden treatments.

    ``treatment_spec`` uses the CSV condition syntax ("C6=25000;C12=0");
    named conditions replace that input column for every served series
    (stored, like the dataset, as log1p).  The importance weights from the
    observed data stay valid, since theta's posterior does not depend on the
    counterfactual input.  One decode of the whole batch, no chunking."""
    device = resolve_device(device)
    overrides = procdata.process_condition(treatment_spec)
    if not overrides:
        raise SystemExit("Unparseable --treatments %r (want e.g. C6=100;C12=0)" % treatment_spec)
    conditions = list(training.settings.data.conditions)
    unknown = [k for k in overrides if k not in conditions]
    if unknown:
        raise SystemExit(
            "--treatments names %s not in the spec's conditions %s" % (unknown, conditions)
        )
    inputs = np.array(host.inputs, np.float32, copy=True)
    for k, v in overrides.items():
        inputs[:, conditions.index(k)] = np.log1p(v)

    rows = np.arange(host.observations.shape[0])
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(AttrDict(host, inputs=inputs), rows, times, device)
    theta_bkn = torch.as_tensor(np.transpose(merged.theta, (1, 2, 0)), device=device)
    log_w = torch.as_tensor(merged.log_w, device=device)
    with torch.no_grad():
        out = training.model.decode(params, theta_bkn, batch, eval_mode=True)
        iw = _importance_weighted_outputs(AttrDict(log_w=log_w), out)
    return AttrDict(spec=treatment_spec, inputs=inputs, **{k: v.cpu().numpy() for k, v in iw.items()})


def save_predictions(path, out, args, settings):
    """Write the prediction npz with the JAX package's key set."""
    merged, host = out.merged, out.host
    payload = dict(
        iw_predict_mu=merged.iw_predict_mu,
        iw_predict_std=merged.iw_predict_std,
        iw_states=merged.iw_states,
        iw_variance=merged.iw_variance,
        per_item_elbo=merged.per_item_elbo,  # per-series IWAE log-evidence
        elbo=merged.elbo,
        q_mu=merged.q_mu,
        q_prec=merged.q_prec,
        q_names=np.array(out.results.q_names, dtype=object),
        species_names=np.array(out.results.species_names, dtype=object),
        devices=host.devices,
        device_names=np.array(list(settings.data.devices), dtype=object),
        inputs=host.inputs,
        observations=host.observations,
        times=host.times,
        scales=np.asarray(out.scales, dtype=np.float64),
        checkpoint_epoch=out.epoch,
    )
    if getattr(args, "save_theta", False) and "theta" in merged:
        payload["theta"] = merged.theta
    for i, cf in enumerate(out.get("counterfactuals") or []):
        payload["cf%d_spec" % i] = np.array(cf.spec)
        payload["cf%d_inputs" % i] = cf.inputs
        for name in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance"):
            payload["cf%d_%s" % (i, name)] = cf[name]
    np.savez(path, **payload)
    print("Wrote %s (%d series, K=%d, checkpoint epoch %d, log-evidence %.2f)"
          % (path, host.observations.shape[0], args.test_samples, out.epoch, merged.elbo))


def make_figure(path_base, out, settings):
    """The prediction-summary figure of ``out`` as ``<path_base>.png`` and
    ``.pdf``."""
    import matplotlib.pyplot as plt

    from vihds_tpu_torch import plotting

    merged, host = out.merged, out.host
    fig = plotting.plot_prediction_summary(
        list(settings.data.devices),
        out.results.species_names,
        host.times,
        host.observations,
        merged.iw_predict_mu,
        merged.iw_predict_std,
        host.devices,
        "-",
    )
    fig.savefig(path_base + ".png", bbox_inches="tight")
    fig.savefig(path_base + ".pdf", bbox_inches="tight")
    plt.close(fig)
    print("Wrote %s.png/.pdf" % path_base)


def main(argv=None, device="cuda"):
    """``python -m vihds_tpu_torch.predict``: restore ``--checkpoint``, predict
    on the ``--data`` CSVs and write ``--output`` (and, with ``--figures``,
    its figure); returns the prediction.  With ``--distributed`` every rank
    predicts, sharded over the mesh of the ``--mesh*`` flags, and rank 0
    writes."""
    parser = create_parser()
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        parser.error("the following arguments are required: --checkpoint")
    if args.figures:
        run_xval.check_figures(packages=("matplotlib", "seaborn"))
    device = resolve_device(device)
    # the process group first, then everything else on this rank's device
    _, rank, device = multihost.initialize_from_args(args, device)
    try:
        settings = Config(args)
        mesh = run_xval.make_mesh_from_args(args, device)
        if mesh is not None:
            print("Device mesh: data=%d x sample=%d" % (mesh.shape["data"], mesh.shape["sample"]))
        with parallel.use_mesh(mesh):
            out = predict(args, settings, device=device)
        if rank == 0:
            save_predictions(args.output, out, args, settings)
            if args.figures:
                make_figure(os.path.splitext(args.output)[0], out, settings)
        return out
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
