"""Synthetic-data generation: sample the spec's generative model and write a
plate-reader CSV the full pipeline can train on (the port of
``vihds_tpu.simulate``).

  theta ~ p(theta)  (tier-faithful: local sites i.i.d. per series, global
                     sites one draw for the whole dataset,
                     global_conditioned sites one draw per device)
  x     = observe(ODE(theta, inputs))        on the source experiment's design
  y     = x + noise(precisions(theta))       Gaussian or Laplace per the spec

Three artifacts go into ``--output_dir``:

  <name>.csv        plate-reader CSV in the exact layout procdata.load parses
  <name>.yaml       derived spec: the source spec with ``files`` pointing at
                    the CSV, ``normalize`` pinned to the generation scales and
                    ``subtract_background: false``, so the training pipeline
                    reproduces the simulated (scaled) observations
  <name>_truth.npz  ground truth: per-series theta (sampled and clipped),
                    site names, decoder parameters (``dec['...']['...']``
                    keys, ``convert.keystr_leaves``), treatments, times, seed

The design (devices, treatments, time grid) is the source spec's real CSVs';
``--n_per_device`` resamples it per device.  ``--sigma_scale`` tempers the
prior of the truth draw on its normal-family sites; ``--max_scaled`` conditions
the draw on the observable regime by blocked rejection
(``sample_truth_theta_in_regime``); ``--calibrate_target`` first descends a
recentering of the shared sites through the differentiable decode
(``calibrate_shared_center``).  Under a spec's ``solver`` / ``eval_solver:
pallas_<method>`` the decode runs the fused kernels (``dr_fwd`` / ``dr_bwd``,
``dr_prec_fwd`` / ``dr_prec_bwd`` and the others), and the calibration's
gradient their backward.

Random draws come from explicit CPU ``torch.Generator``s, one per use,
seeded from ``--seed`` (``generator``): the truth theta (a generator per
rejection attempt and local round, ``truth_draws``), the decoder's init and
the noise.  They are moved to the device afterwards, so a seed gives the same
truth on the CPU and on the card.  The numbers differ from the JAX package's,
whose stream is JAX's; the functions take the draws as arguments, so a test
can hand them the JAX package's.

CLI::

  python -m vihds_tpu_torch.simulate <spec.yaml> --output_dir DIR [--name synthetic]
      [--seed 0] [--sigma_scale 1.0] [--n_per_device N] [--max_scaled X]
      [--calibrate_target Y]

It runs on the CUDA device unless ``main`` or ``simulate`` is given
``device="cpu"``.
"""

import argparse
import contextlib
import csv
import os
import time

import numpy as np
import torch
import yaml

from vihds_tpu_torch import models
from vihds_tpu_torch.config import Config
from vihds_tpu_torch.convert import keystr_leaves
from vihds_tpu_torch.data import procdata
from vihds_tpu_torch.data.datasets import get_cassettes, merge_observations
from vihds_tpu_torch.prob import ParamProgram, parse_parameters
from vihds_tpu_torch.utils import resolve_device
from vihds_tpu_torch.utils.attrdict import AttrDict
from vihds_tpu_torch.vae import params_to

#: the generator streams of one ``--seed``
STREAM_THETA, STREAM_DECODER, STREAM_NOISE = 0, 1, 2


def create_parser():
    parser = argparse.ArgumentParser(description="VI-HDS synthetic-data simulator (PyTorch)")
    parser.add_argument("yaml", type=str, help="Source spec (defines model, priors, design CSVs)")
    parser.add_argument("--output_dir", type=str, required=True, help="Directory for csv/yaml/npz")
    parser.add_argument("--name", type=str, default="synthetic", help="Basename for the artifacts")
    parser.add_argument("--seed", type=int, default=0, help="RNG seed (theta draw + noise)")
    parser.add_argument(
        "--sigma_scale",
        type=float,
        default=1.0,
        help="Temper the truth draw: normal-family prior sigmas scale by this factor",
    )
    parser.add_argument(
        "--n_per_device",
        type=int,
        default=None,
        help="Resample the design to N series per device (default: keep the source design)",
    )
    parser.add_argument(
        "--max_scaled",
        type=float,
        default=None,
        help="Condition the truth draw on the observable regime via blocked "
        "rejection: noiseless scaled trajectories must peak at or below this "
        "bound (real scaled data peaks at 1.0 by construction; default: accept "
        "any draw)",
    )
    parser.add_argument(
        "--calibrate_target",
        type=float,
        default=None,
        help="Gradient-calibrate the shared-block truth center so the probe "
        "trajectories peak at ~this value BEFORE drawing (use when the spec's "
        "prior-predictive sits far from the data scale; the truth distribution "
        "becomes the recentered tempered prior, recorded in the truth npz)",
    )
    # Config reads these training-loop fields; they are inert here.
    parser.set_defaults(epochs=0, test_epoch=0, plot_epoch=0)
    return parser


def load_design(settings):
    """The experimental design of the source spec's real data:
    (devices[L] int, treatments[L,C] raw, times[T]).  Uses the same
    merge-to-coarsest-grid rule as training."""
    parsed = [procdata.load(f, settings.data) for f in settings.data.files]
    parsed = [p for p in parsed if p is not None]
    if not parsed:
        raise SystemExit("No design rows for devices %s" % list(settings.data.devices))
    devices = np.concatenate([p[0] for p in parsed])
    treatments = np.concatenate([p[1] for p in parsed])
    times, _ = merge_observations([p[2] for p in parsed], [p[3] for p in parsed])
    return devices, treatments, np.asarray(times)


def resample_design(devices, treatments, n_per_device, seed):
    """N rows per device, sampled with replacement from that device's rows."""
    rng = np.random.RandomState(seed)
    keep = []
    for d in np.unique(devices):
        rows = np.flatnonzero(devices == d)
        keep.append(rng.choice(rows, size=n_per_device, replace=True))
    keep = np.concatenate(keep)
    return devices[keep], treatments[keep]


def generator(seed, *ids):
    """A CPU generator for the stream ``ids`` of ``seed`` (a 63-bit seed from
    numpy's ``SeedSequence`` of both)."""
    state = np.random.SeedSequence([seed, *ids]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def truth_draws(seed, n_series, n_theta):
    """The truth's raw standard-normal draws [L, 1, n_theta] as a function of
    (shared attempt, local round): ``draw(attempt)`` for stage A's shared
    draw, ``draw(attempt, rnd)`` for stage B's redraw of round ``rnd`` under
    that attempt (the JAX package's ``fold_in(key, attempt)`` and
    ``fold_in(k_a, 10000 + rnd)``), each from a generator of its own."""

    def draw(attempt, rnd=None):
        ids = (STREAM_THETA, attempt) if rnd is None else (STREAM_THETA, attempt, 1 + rnd)
        return torch.randn((n_series, 1, n_theta), generator=generator(seed, *ids)).numpy()

    return draw


def tie(program, devices, xi, center=None):
    """One u per (site, sharing unit) from the raw draw xi [L, 1, n_theta]:
    local sites i.i.d. per series, global (and constant) sites one draw for
    every series (series 0's), global_conditioned sites one draw per device
    (its first series').  ``center`` (a [n_theta] vector, zero on local
    sites) recenters the draw: u = center + xi."""
    u = np.array(xi, np.float32)
    for sl in (program.global_slice, program.constant_slice):
        u[:, :, sl] = u[0:1, :, sl]
    for d in np.unique(devices):
        rows = np.flatnonzero(devices == d)
        u[rows, :, program.global_cond_slice] = u[rows[0], :, program.global_cond_slice]
    if center is not None:
        u += np.asarray(center, np.float32)[None, None, :]
    return u


def _shared_site_mask(program):
    mask = np.zeros(program.n_theta, bool)
    mask[program.global_slice] = True
    mask[program.global_cond_slice] = True
    return mask


def truth_q(program, sigma_scale, device="cpu"):
    """The tempered prior as q-style tensors: normal-family sites' precisions
    divided by ``sigma_scale`` squared."""
    prec = np.where(
        program.is_normal_family,
        program.prior_prec / float(sigma_scale) ** 2,
        program.prior_prec,
    ).astype(np.float32)
    return AttrDict(
        mu=torch.as_tensor(program.prior_mu, device=device)[None, :],
        prec=torch.as_tensor(prec, device=device)[None, :],
    )


def _probe_theta(program, n_series, q_truth, center):
    """The probe's clipped theta: every series at u = ``center`` (a [n_theta]
    tensor), the local sites at their prior mean."""
    u = torch.broadcast_to(center[None, None, :], (n_series, 1, program.n_theta))
    return program.clip(program.sample(q_truth, u), stddevs=4)


def calibrate_shared_center(
    program, n_series, decode_diff, sigma_scale, target_peak,
    steps=200, lr=0.05, ridge=1e-3, device="cpu",
):
    """Gradient-calibrate the shared-block center of the truth draw so the
    probe dataset (locals at their prior mean) peaks at ~``target_peak``.

    A spec's prior-predictive can sit far from the real data's scale
    (dr_constant_one's prior-center trajectories peak at 6x the
    per-signal-max-normalised data), where rejection alone never reaches the
    data regime.  The decode is differentiable, so Adam descends a center g
    over the shared sites (``torch.optim.Adam``, optax's ``adam``) minimising

        (log peak(g) - log target)^2 + ridge * |g|^2

    the smallest recentering of the tempered prior that puts the probe
    trajectories at the data scale.  The gradient of the peak is one-hot at
    the largest |x|; under ``solver: pallas_<method>`` it runs the fused
    kernels' backward once a step.

    Returns (center [n_theta] float32, zero on local/constant sites;
    achieved probe peak)."""
    device = torch.device(device)
    shared = torch.as_tensor(_shared_site_mask(program), dtype=torch.float32, device=device)
    q_truth = truth_q(program, sigma_scale, device)
    log_target = torch.log(torch.tensor(float(target_peak), dtype=torch.float32, device=device))

    def probe_peak(g):
        return torch.max(torch.abs(decode_diff(_probe_theta(program, n_series, q_truth, g))))

    g = torch.zeros(program.n_theta, dtype=torch.float32, device=device, requires_grad=True)
    adam = torch.optim.Adam([g], lr=lr)
    for _ in range(steps):
        adam.zero_grad(set_to_none=True)
        loss = (torch.log(probe_peak(g * shared)) - log_target) ** 2 + ridge * torch.sum(g * g)
        loss.backward()
        adam.step()
    center = (g.detach() * shared).cpu().numpy().astype(np.float32)
    with torch.no_grad():
        achieved = float(probe_peak(torch.as_tensor(center, device=device)))
    print(
        "simulate: calibrated shared center |g|=%.2f, probe peak %.3f (target %.2f)"
        % (float(np.linalg.norm(center)), achieved, target_peak)
    )
    return center, achieved


def probe_peak_through(program, n_series, decode_fn, sigma_scale, center, device="cpu"):
    """The calibration probe's peak through an arbitrary decode (the
    eval_mode decode that generates the data, where a spec's solver and
    eval_solver differ)."""
    q_truth = truth_q(program, sigma_scale, device)
    with torch.no_grad():
        clipped = _probe_theta(program, n_series, q_truth, torch.as_tensor(center, device=device))
        return float(torch.max(torch.abs(decode_fn(clipped))))


def _theta_from_u(program, u, sigma_scale):
    """Push tied u through the spec's own sampling machinery (dependent sites
    and non-Normal kinds included), on the host, so the truth distribution
    is exactly the model's prior tempered by ``sigma_scale`` on
    normal-family sigmas.  Returns numpy (theta, theta_clipped); the decoder
    integrates the +-4-sigma-clipped theta (bounds from the untempered
    prior, as in training)."""
    with torch.no_grad():
        theta = program.sample(truth_q(program, sigma_scale), torch.as_tensor(u))
        clipped = program.clip(theta, stddevs=4)
    return theta.numpy(), clipped.numpy()


def sample_truth_theta_in_regime(
    program, devices, draw, sigma_scale, max_scaled, noiseless_fn,
    max_attempts=1000, max_rounds=50, center=None,
):
    """Blocked rejection: a tempered-prior draw conditioned on the observable
    regime (noiseless scaled trajectories peak at or below ``max_scaled``).

    A joint all-series rejection has vanishing acceptance, so it is blocked
    at the sharing structure of the hierarchy:

      Stage A: redraw the SHARED blocks (global / global_conditioned /
        constant) until the probe dataset (every series with its local sites
        at the prior mean, u_local = 0) is in regime.
      Stage B: with the shared draw frozen, redraw each OFFENDING series'
        local block independently until its own trajectory is in regime.

    ``draw(attempt)`` gives stage A's raw draw of that attempt and
    ``draw(attempt, rnd)`` stage B's of round ``rnd`` (``truth_draws``).
    ``noiseless_fn(theta_clipped) -> x_predict [L, 1, S, T]`` is the spec's
    own decode.  Returns (theta, theta_clipped, stats dict)."""
    # Stage A: shared blocks against the probe dataset
    loc = program.local_slice
    for attempt in range(max_attempts):
        u = tie(program, devices, draw(attempt), center=center)
        u_probe = u.copy()
        u_probe[:, :, loc] = 0.0
        _, probe_clipped = _theta_from_u(program, u_probe, sigma_scale)
        probe_peak = float(torch.max(torch.abs(noiseless_fn(probe_clipped))))
        if probe_peak <= max_scaled:
            break
        if attempt < 5 or attempt % 25 == 0:
            print(
                "simulate: shared draw %d rejected (probe peak %.1f > max_scaled %.1f)"
                % (attempt, probe_peak, max_scaled)
            )
    else:
        raise SystemExit(
            "simulate: no in-regime SHARED draw in %d attempts; raise "
            "--max_scaled or lower --sigma_scale" % max_attempts
        )

    # Stage B: per-series local blocks under the frozen shared draw
    for rnd in range(max_rounds):
        theta, clipped = _theta_from_u(program, u, sigma_scale)
        x_predict = torch.abs(noiseless_fn(clipped))
        per_series_peak = torch.amax(x_predict, dim=tuple(range(1, x_predict.dim()))).cpu().numpy()
        bad = per_series_peak > max_scaled
        if not bad.any():
            return theta, clipped, dict(
                truth_attempt=attempt,
                probe_peak=probe_peak,
                local_rounds=rnd,
                noiseless_peak=float(per_series_peak.max()),
            )
        print(
            "simulate: round %d — redrawing %d/%d local blocks (worst peak %.1f)"
            % (rnd, int(bad.sum()), len(bad), float(per_series_peak.max()))
        )
        fresh = tie(program, devices, draw(attempt, rnd), center=center)
        u[bad, :, loc] = fresh[bad, :, loc]
    raise SystemExit(
        "simulate: %d series still out of regime after %d local redraw rounds; "
        "raise --max_scaled or lower --sigma_scale" % (int(bad.sum()), max_rounds)
    )


def make_decoder(settings, program, devices, treatments, times, gen, eval_mode=True,
                 device="cuda", params_dec=None, dtype=torch.float32):
    """The spec's generative decode as a function of theta alone.

    The design (dev_1hot, log-treatments, time grid) and the decoder params
    (drawn from the CPU generator ``gen``, or ``params_dec`` as given) are
    closed over.  Returns (ode_model, params_dec, decode:
    theta_clipped[L,1,n_theta] -> (x_predict[L,1,S,T], precisions)), the
    outputs tensors on ``device``; with ``eval_mode`` the decode runs the
    spec's ``eval_solver`` (where it has one) under ``torch.no_grad()``,
    else its ``solver`` with the graph kept for a gradient.  ``dtype``
    (float64 for a reference of a generic solver; the fused kernels are
    float32) is the design's and theta's; ``params_dec`` is taken as given."""
    device = resolve_device(device)
    ode_model = models.LOOKUP[settings.model](settings)
    condition_on_device = settings.data.device_depth > 1
    if not condition_on_device:
        ode_model.conditioned_params = ()
    if params_dec is None:
        params_dec = params_to(ode_model.init_params(gen), device)

    dev_1hot = torch.as_tensor(get_cassettes(devices, settings.data), dtype=dtype, device=device)
    inputs_log = torch.as_tensor(np.log1p(treatments).astype(np.float32), dtype=dtype,
                                 device=device)
    times_t = torch.as_tensor(times.astype(np.float32), dtype=dtype, device=device)
    n_times = len(times)

    def decode(theta_clipped):
        with torch.no_grad() if eval_mode else contextlib.nullcontext():
            if not torch.is_tensor(theta_clipped):
                theta_clipped = np.array(theta_clipped, np.float32)
            theta = torch.as_tensor(theta_clipped, dtype=dtype, device=device)
            th = program.theta_dict(theta)
            if condition_on_device:
                th = ode_model.condition_theta(params_dec, th, dev_1hot)
            x_solution = ode_model.simulate(
                params_dec, th, times_t, inputs_log, dev_1hot, n_iwae=1, eval_mode=eval_mode
            )
            x_states, precisions = ode_model.expand_precisions(
                params_dec, th, n_times, x_solution
            )
            return ode_model.observe(x_states, th), precisions  # [L, 1, S, T]

    return ode_model, params_dec, decode


def add_observation_noise(ode_model, x_predict, precisions, gen=None, eps=None):
    """Observation noise from the model's own precision sites: ``eps``, a
    standard Laplace or normal draw of x_predict's shape (from the CPU
    generator ``gen`` where not given), over the precision (Laplace, whose
    log-likelihood is rate-parameterised: scale 1/precision) or its square
    root (Gaussian).  Returns numpy (obs[L,S,T] in SCALED model units,
    precisions[L,S,T])."""
    shape = tuple(x_predict.shape)
    if eps is None:
        if ode_model.use_laplace:
            v = torch.clamp(2.0 * torch.rand(shape, generator=gen) - 1.0,
                            min=-1.0 + float(np.finfo(np.float32).eps))
            eps = -torch.sign(v) * torch.log1p(-torch.abs(v))
        else:
            eps = torch.randn(shape, generator=gen)
    eps = torch.as_tensor(eps, dtype=x_predict.dtype).to(x_predict.device)
    if ode_model.use_laplace:
        noise = eps / precisions
    else:
        noise = eps / torch.sqrt(precisions)
    obs = (x_predict + noise).cpu().numpy()[:, 0]  # [L, S, T]
    precisions = torch.broadcast_to(precisions, shape).cpu().numpy()[:, 0]
    return obs, precisions


def write_csv(path, settings, devices, treatments, times, raw_obs):
    """Plate-reader CSV in the layout procdata.load parses: row 0 after the
    header holds the observation times from column 5 on; each later row is
    one well."""
    signals = list(settings.data.signals)
    conditions = list(settings.data.conditions)
    name_of = settings.data.device_idx_to_device_name
    T = len(times)
    header = ["Content", "Colony", "Well Col", "Well Row", "Conditions"]
    col_id = 0
    for sig in signals:
        for _ in range(T):
            col_id += 1
            header.append("%d (%s)" % (col_id, sig))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        # times row: one entry per reading column
        w.writerow(
            ["timesall", "", "", "", ""]
            + [repr(float(t)) for _ in signals for t in times]
        )
        for i in range(len(devices)):
            cond = ";".join(
                "%s=%s" % (c, repr(float(v))) for c, v in zip(conditions, treatments[i])
            )
            row = [name_of[int(devices[i])], 1, (i % 12) + 1, (i // 12) + 1, cond]
            for s in range(len(signals)):
                row.extend(repr(float(v)) for v in raw_obs[i, s])
            w.writerow(row)


def write_derived_spec(path, source_yaml, csv_path, scales):
    """The source spec with ``files`` -> the synthetic CSV (absolute path, so
    it resolves under any INFERENCE_DATA_DIR), ``normalize`` pinned to the
    generation scales and background subtraction off."""
    with open(source_yaml) as f:
        spec = yaml.safe_load(f)
    spec["data"]["files"] = [os.path.abspath(csv_path)]
    spec["data"]["normalize"] = [float(s) for s in scales]
    spec["data"]["subtract_background"] = False
    with open(path, "w") as f:
        yaml.safe_dump(spec, f, sort_keys=False)


def simulate(args, device="cuda"):
    """Run the simulator on ``device``; returns AttrDict with every artifact
    path, the in-memory truth (theta, obs, ...) and ``seconds``, the wall
    time of each stage (``calibrate``, ``reject``, ``write``)."""
    device = resolve_device(device)
    settings = Config(args)
    program = ParamProgram(parse_parameters(settings.params))

    devices, treatments, times = load_design(settings)
    if args.n_per_device:
        devices, treatments = resample_design(devices, treatments, args.n_per_device, args.seed)

    ode_model, params_dec, decode = make_decoder(
        settings, program, devices, treatments, times,
        generator(args.seed, STREAM_DECODER), device=device,
    )
    seconds = {}

    center = None
    stats = dict(truth_attempt=0, local_rounds=0)
    if args.calibrate_target:
        t0 = time.perf_counter()
        _, _, decode_diff = make_decoder(
            settings, program, devices, treatments, times, None, eval_mode=False,
            device=device, params_dec=params_dec,
        )
        center, calibrated_peak = calibrate_shared_center(
            program, len(devices), lambda c: decode_diff(c)[0],
            args.sigma_scale, args.calibrate_target, device=device,
        )
        # The probe peak through the EVAL decode, the one data generation
        # uses; it differs from calibrated_peak only when the spec's solver
        # and eval_solver differ.
        calibrated_peak_eval = probe_peak_through(
            program, len(devices), lambda c: decode(c)[0], args.sigma_scale, center,
            device=device,
        )
        if abs(calibrated_peak_eval - calibrated_peak) > 0.05 * max(calibrated_peak, 1e-9):
            print(
                "simulate: NOTE eval-decode probe peak %.3f differs from the "
                "train-decode calibrated peak %.3f (solver vs eval_solver)"
                % (calibrated_peak_eval, calibrated_peak)
            )
        stats.update(
            u_center=center,
            calibrated_peak=calibrated_peak,
            calibrated_peak_eval=calibrated_peak_eval,
        )
        seconds["calibrate"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    draw = truth_draws(args.seed, len(devices), program.n_theta)
    if args.max_scaled:
        theta, theta_clipped, in_regime = sample_truth_theta_in_regime(
            program, devices, draw, args.sigma_scale, args.max_scaled,
            noiseless_fn=lambda clipped: decode(clipped)[0],
            center=center,
        )
        stats.update(in_regime)
    else:
        u = tie(program, devices, draw(0), center=center)
        theta, theta_clipped = _theta_from_u(program, u, args.sigma_scale)

    # How much the +-4sigma clip bit the truth draw: recovery scores against
    # theta_clipped (what the decoder integrated)
    clip_frac = float(np.mean(theta != theta_clipped))
    if clip_frac:
        print("simulate: clip saturation on %.2f%% of truth coordinates" % (100 * clip_frac))
    stats.update(clip_saturation=clip_frac)

    x_predict, prec = decode(theta_clipped)
    obs, truth_prec = add_observation_noise(
        ode_model, x_predict, prec, generator(args.seed, STREAM_NOISE)
    )
    x_noiseless = x_predict.cpu().numpy()[:, 0]
    stats.setdefault("noiseless_peak", float(np.max(np.abs(x_noiseless))))
    seconds["reject"] = time.perf_counter() - t0

    # Source-like units: scale by the per-signal max of the SOURCE data (the
    # statistic the default pipeline normalises by).  The derived spec pins
    # normalize to these values, so loaded observations == obs (up to one
    # f32 multiply/divide round-trip).
    t0 = time.perf_counter()
    src = [procdata.load(f, settings.data) for f in settings.data.files]
    scales = [
        float(max(np.max(p[3][:, i, :]) for p in src if p is not None))
        for i in range(obs.shape[1])
    ]
    raw = obs * np.asarray(scales, np.float32)[None, :, None]

    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, args.name + ".csv")
    spec_path = os.path.join(args.output_dir, args.name + ".yaml")
    truth_path = os.path.join(args.output_dir, args.name + "_truth.npz")
    write_csv(csv_path, settings, devices, treatments, times, raw)
    write_derived_spec(spec_path, args.yaml, csv_path, scales)

    payload = dict(
        theta=theta[:, 0],
        theta_clipped=theta_clipped[:, 0],
        theta_names=np.array(program.names, dtype=object),
        devices=devices,
        treatments=treatments,
        times=times,
        observations=obs,
        x_noiseless=x_noiseless,
        precisions=truth_prec,
        scales=np.asarray(scales, np.float64),
        seed=args.seed,
        sigma_scale=args.sigma_scale,
        max_scaled=args.max_scaled or 0.0,
        **stats,
    )
    payload.update(keystr_leaves(params_dec, "dec"))
    np.savez(truth_path, **payload)
    seconds["write"] = time.perf_counter() - t0
    print(
        "Wrote %s (%d series x %d signals x %d times), %s, %s"
        % (csv_path, obs.shape[0], obs.shape[1], obs.shape[2], spec_path, truth_path)
    )
    return AttrDict(
        csv=csv_path,
        spec=spec_path,
        truth=truth_path,
        theta=theta[:, 0],
        theta_clipped=theta_clipped[:, 0],
        observations=obs,
        devices=devices,
        treatments=treatments,
        times=times,
        scales=scales,
        program=program,
        seconds=seconds,
    )


def main(argv=None, device="cuda"):
    return simulate(create_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
