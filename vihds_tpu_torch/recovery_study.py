"""Simulation-based parameter-recovery study: simulate -> infer -> compare
(the port of ``tools/recovery_study.py``, its amortised half).

Draw a KNOWN ground truth from the model's own (tempered) prior, simulate a
plate-reader dataset from it (``vihds_tpu_torch.simulate``), train the
amortised VI stack on that dataset, then measure how well the recovered
posterior covers the truth:

  * per-site posterior z-scores  z = (q_mu - truth) * sqrt(q_prec)
    (log-space for LogNormal sites), with 95% credible-interval coverage;
  * across-series correlation between the amortised per-series posterior
    means and the per-series truth for LOCAL sites;
  * posterior-predictive coverage: the fraction of observed points inside
    mu +- 1.96 sigma of the importance-weighted predictive distribution.

Writes REPORT.md + recovery.npz into ``--outdir``, with the reference tool's
keys and layout.  The HMC refinement stages (``--refine_chains``,
``--pooled_chains``) wait for ``refine.py``: a non-zero value stops the
study before it starts.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU)::

  python -m vihds_tpu_torch.recovery_study --refine_chains 0 --pooled_chains 0 \\
      [--spec specs/dr_constant_one.yaml] [--epochs 1000] [--outdir DIR]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from vihds_tpu_torch.config import _REPO

#: the title of the ROADMAP queue 1 item that ports the HMC stages
REFINE_ITEM = "refine.py"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", default=os.path.join(_REPO, "specs", "dr_constant_one.yaml"))
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--test_epoch", type=int, default=50)
    p.add_argument("--train_samples", type=int, default=200)
    p.add_argument("--test_samples", type=int, default=1000)
    p.add_argument("--n_per_device", type=int, default=48)
    p.add_argument("--sigma_scale", type=float, default=0.5)
    p.add_argument(
        "--max_scaled",
        type=float,
        default=2.0,
        help="Condition the truth draw on the observable regime: redraw until the "
        "noiseless scaled trajectories peak at or below this (real data peaks at "
        "1.0 by construction); 0 disables the conditioning",
    )
    p.add_argument(
        "--calibrate_target",
        type=float,
        default=1.0,
        help="Gradient-calibrate the shared-block truth center to this probe peak "
        "before drawing (the dr_constant prior-predictive CENTER peaks at 6x the "
        "data scale, so rejection alone cannot reach the data regime); 0 disables",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--grad_clip_norm", type=float, default=10.0,
        help="Global-norm gradient clip for the training phase (default 10, "
        "the shipped inference-graph convention: NeuralPrecisions at the "
        "spec lr=0.01 blows up without it on off-regime data; 0 disables)",
    )
    p.add_argument("--folds", type=int, default=4, help="train on (folds-1)/folds of the data")
    p.add_argument(
        "--refine_chains",
        type=int,
        default=64,
        help="After the amortised comparison, HMC-refine the LOCAL sites per "
        "series with this many chains (not ported yet: pass 0)",
    )
    p.add_argument("--refine_steps", type=int, default=200, help="HMC steps (not ported yet)")
    p.add_argument(
        "--pooled_chains",
        type=int,
        default=32,
        help="Also run POOLED joint HMC with this many chains (not ported yet: pass 0)",
    )
    p.add_argument("--pooled_steps", type=int, default=300)
    p.add_argument("--outdir", default=os.path.join(_REPO, "build", "recovery_study"))
    return p.parse_args(argv)


def check_ported(args):
    """Stop, before any stage, where an HMC stage is asked for."""
    for flag in ("refine_chains", "pooled_chains"):
        if getattr(args, flag):
            raise SystemExit(
                '--%s is not ported to vihds_tpu_torch yet (ROADMAP queue 1, "%s"); '
                "pass --refine_chains 0 --pooled_chains 0" % (flag, REFINE_ITEM)
            )


def _ess_rhat_coord(x):
    """One scalar coordinate's kept draws ``x [S, C]`` across C chains ->
    (effective sample size, split-R-hat).  ESS uses the chain-averaged
    autocorrelation with an initial-positive-sequence cutoff; R-hat splits
    each chain in half (Gelman et al.)."""
    S, C = x.shape
    half = S // 2
    if half < 2:
        return float("nan"), float("nan")
    xs = np.concatenate([x[:half], x[half: 2 * half]], axis=1)  # [half, 2C]
    m, v = xs.mean(0), xs.var(0, ddof=1)
    W = float(v.mean())
    Bv = half * float(m.var(ddof=1))
    if W <= 0:
        return 0.0, (float("inf") if Bv > 0 else 1.0)
    var_hat = (half - 1) / half * W + Bv / half
    rhat = float(np.sqrt(var_hat / W))
    xc = x - x.mean(0, keepdims=True)
    s2 = float(x.var(0, ddof=1).mean())
    if s2 <= 0:
        return 0.0, rhat
    rho_sum = 0.0
    for t in range(1, min(S - 1, 100)):
        rho = float(np.mean((xc[:-t] * xc[t:]).sum(0) / (S - t)) / s2)
        if rho < 0.05:
            break
        rho_sum += rho
    return S * C / (1.0 + 2.0 * rho_sum), rhat


def mixing_summary(coords):
    """Aggregate ESS / split-R-hat over an iterable of [S, C] coordinate
    traces."""
    esss, rhats = [], []
    for x in coords:
        e, r = _ess_rhat_coord(np.asarray(x, np.float64))
        if np.isfinite(e):
            esss.append(e)
        if np.isfinite(r):
            rhats.append(r)
    if not esss:
        return None
    rh = np.asarray(rhats)
    return dict(
        ess_median=float(np.median(esss)),
        ess_min=float(np.min(esss)),
        rhat_max=float(rh.max()),
        rhat_frac_ok=float(np.mean(rh < 1.05)),
        n_coords=len(esss),
    )


def rms_displacement(z, z_init, prior_prec, cols):
    """|z - z_init| in PRIOR-SIGMA units over the moved columns: median and
    RMS.  Distinguishes 'chains equilibrated elsewhere' from 'chains barely
    left the amortised init'."""
    d = (np.asarray(z, np.float64) - np.asarray(z_init, np.float64)) * np.sqrt(
        np.asarray(prior_prec, np.float64)
    )[None, None, :]
    d = d[:, :, cols]
    return float(np.median(np.abs(d))), float(np.sqrt(np.mean(d ** 2)))


def site_comparisons(program, q_mu, q_prec, truth_theta):
    """Per-site z-scores of the truth under the recovered posterior.

    Normal-family sites only (LogNormal scores in log space: the (mu, prec)
    the encoder emits parameterise the underlying normal).  Returns
    [(name, tier, z[L] or z[()], corr-or-None), ...] for non-constant sites."""
    rows = []
    n_loc = program.local_slice.stop - program.local_slice.start
    n_gc = program.global_cond_slice.stop - program.global_cond_slice.start
    for i, name in enumerate(program.names):
        if bool(program.is_constant[i]) or bool(program.is_kumaraswamy[i]):
            continue
        t = truth_theta[:, i].astype(np.float64)
        t = np.log(np.maximum(t, 1e-30)) if program.is_lognormal[i] else t
        mu = q_mu[:, i].astype(np.float64)
        sd = 1.0 / np.sqrt(np.maximum(q_prec[:, i].astype(np.float64), 1e-30))
        if i < n_loc:
            tier = "local"
            z = (mu - t) / sd
            corr = float(np.corrcoef(mu, t)[0, 1]) if np.ptp(t) > 0 else None
        elif i < n_loc + n_gc:
            tier = "global_cond"
            z = np.array([(mu.mean() - t[0]) / max(sd.mean(), 1e-30)])
            corr = None
        else:
            tier = "global"
            z = np.array([(mu.mean() - t[0]) / max(sd.mean(), 1e-30)])
            corr = None
        rows.append((name, tier, z, corr))
    return rows


def headline(program, rec):
    """The per-site rows and the four headline statistics of a recovery
    (``rec``: q_mu, q_prec, truth_theta, observations, iw_predict_mu,
    iw_predict_std, as recovery.npz holds them).  Returns (rows, dict of
    median_abs_z, coverage95, predictive_coverage95, median_local_corr)."""
    rows = site_comparisons(program, rec["q_mu"], rec["q_prec"], rec["truth_theta"])
    obs = rec["observations"]
    lo = rec["iw_predict_mu"] - 1.96 * rec["iw_predict_std"]
    hi = rec["iw_predict_mu"] + 1.96 * rec["iw_predict_std"]
    all_z = np.concatenate([np.atleast_1d(z) for _, _, z, _ in rows])
    local_rows = [r for r in rows if r[1] == "local"]
    return rows, dict(
        median_abs_z=float(np.median(np.abs(all_z))),
        coverage95=float(np.mean(np.abs(all_z) < 1.96)),
        predictive_coverage95=float(np.mean((obs >= lo) & (obs <= hi))),
        median_local_corr=float(
            np.median([c for _, _, _, c in local_rows if c is not None])
        ) if local_rows else None,
    )


def report_lines(args, truth, summary, rows):
    """REPORT.md of a study without the HMC stages, as lines: the reference
    tool's layout."""
    n_series = summary["n_series"]
    lines = [
        "# Parameter-recovery study (simulate -> infer -> compare)",
        "",
        "Spec `%s`; truth drawn from the tempered prior (sigma_scale=%.2f, seed=%d),"
        % (os.path.basename(args.spec), args.sigma_scale, args.seed),
        "conditioned on the observable regime%s by blocked rejection (noiseless "
        "scaled peak %.2f <= max_scaled %.1f; shared draw accepted on attempt "
        "%d, %d local redraw rounds; real data peaks at 1.0);"
        % (
            " around a gradient-calibrated shared center (probe peak %.2f, "
            "target %.1f — the spec's prior-predictive center sits at 6x the "
            "data scale)" % (float(truth["calibrated_peak"]), args.calibrate_target)
            if "calibrated_peak" in truth
            else "",
            float(truth["noiseless_peak"]), args.max_scaled,
            int(truth["truth_attempt"]), int(truth["local_rounds"]),
        )
        if args.max_scaled
        else "with NO regime conditioning (noiseless scaled peak %.2f; real data "
        "peaks at 1.0);" % float(truth["noiseless_peak"]),
        "%d synthetic series; trained %d epochs (K_train=%d, K_eval=%d, %d/%d split)."
        % (n_series, args.epochs, args.train_samples, args.test_samples,
           args.folds - 1, args.folds),
        "Pipeline: vihds_tpu_torch/simulate.py -> the standard training stack -> "
        "posterior vs `synthetic_truth.npz`.",
        "",
        "## Headline",
        "",
        "| metric | value |",
        "|---|---|",
        "| median abs z (truth under recovered posterior) | %.2f |" % summary["median_abs_z"],
        "| 95%% credible-interval coverage of truth | %.1f%% |" % (100 * summary["coverage95"]),
        "| posterior-predictive 95%% coverage of data | %.1f%% |"
        % (100 * summary["predictive_coverage95"]),
        "| median across-series corr(q_mu, truth), local sites | %s |"
        % ("%.3f" % summary["median_local_corr"] if summary["median_local_corr"] is not None
           else "n/a"),
        "| final val IWAE-ELBO | %.1f |" % summary["val_elbo"],
        "",
        "z = (q_mu - truth) * sqrt(q_prec), log-space for LogNormal sites.",
        "",
        "## Per-site",
        "",
        "| site | tier | median z | median abs z | cover95 | corr(series) |",
        "|---|---|---|---|---|---|",
    ]
    for name, tier, z, corr in rows:
        z = np.atleast_1d(z)
        lines.append(
            "| %s | %s | %+.2f | %.2f | %.0f%% | %s |"
            % (
                name,
                tier,
                float(np.median(z)),
                float(np.median(np.abs(z))),
                100 * float(np.mean(np.abs(z) < 1.96)),
                "%.3f" % corr if corr is not None else "—",
            )
        )
    lines += [
        "",
        "## Reading the table",
        "",
        "Global-tier sites are constrained by every series jointly, so |z| < 1.96",
        "with high cover95 is the expected signature of correct inference.  Local",
        "sites are informed only by their own series through the amortised encoder:",
        "corr(series) measures whether the encoder genuinely tracks the per-series",
        "truth, and cover95 exposes the well-documented overconfidence of amortised",
        "variational posteriors (compare the posterior-predictive coverage, which",
        "stays calibrated when the fit is good).  The HMC section separates the",
        "two possible causes: if refined coverage recovers toward 95%, the gap was",
        "the amortisation; if it does NOT move despite healthy mixing (the ESS /",
        "split-R-hat / displacement line above — acceptance alone does not show",
        "the chains equilibrated), the exact",
        "per-series posterior itself sits away from the truth — in a hierarchical",
        "model, small finite-data biases in the shared sites are compensated by",
        "the local conditionals, a property of the model/data pairing rather than",
        "an inference failure (the posterior-predictive coverage is the check",
        "that the fit itself is calibrated).",
        "",
        "Reproduce: `python -m vihds_tpu_torch.recovery_study --epochs %d --seed %d "
        "--sigma_scale %s --max_scaled %s --calibrate_target %s "
        "--n_per_device %d --refine_chains %d --refine_steps %d "
        "--pooled_chains %d --pooled_steps %d --outdir %s`"
        % (args.epochs, args.seed, args.sigma_scale, args.max_scaled,
           args.calibrate_target, args.n_per_device, args.refine_chains,
           args.refine_steps, args.pooled_chains, args.pooled_steps,
           args.outdir),
        "",
    ]
    return lines


def simulate_stage(args, device):
    """Stage 1/3: the simulator at the study's flags, its artifacts written
    into ``args.outdir`` as ``synthetic.*``."""
    from vihds_tpu_torch import simulate as sim

    print("=== 1/3 simulate (truth ~ tempered prior, sigma_scale=%.2f) ===" % args.sigma_scale)
    sim_args = sim.create_parser().parse_args(
        [
            args.spec,
            "--output_dir", args.outdir,
            "--name", "synthetic",
            "--seed", str(args.seed),
            "--sigma_scale", str(args.sigma_scale),
            "--n_per_device", str(args.n_per_device),
        ]
        + (["--max_scaled", str(args.max_scaled)] if args.max_scaled else [])
        + (["--calibrate_target", str(args.calibrate_target)] if args.calibrate_target else [])
    )
    return sim.simulate(sim_args, device=device)


def train_and_score(args, spec, truth_path, device):
    """Stages 2/3 and 3/3: train on the simulated ``spec`` (a derived spec
    the simulator wrote), evaluate every series and score the recovered
    posterior against ``truth_path`` (its truth npz); writes recovery.npz
    and REPORT.md into ``args.outdir`` and returns the summary.  A recorded
    simulation (its spec's ``files`` pointed at its CSV) can be scored
    again this way without stage 1."""
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.run_xval import create_parser
    from vihds_tpu_torch.training import Training
    from vihds_tpu_torch.vae import VAE

    os.makedirs(args.outdir, exist_ok=True)
    print("=== 2/3 train on the synthetic spec ===")
    targs = create_parser(True).parse_args([spec])
    targs.seed = args.seed
    targs.epochs = args.epochs
    targs.test_epoch = args.test_epoch
    targs.plot_epoch = 0
    targs.train_samples = args.train_samples
    targs.test_samples = args.test_samples
    targs.folds = args.folds
    targs.split = 1
    if args.grad_clip_norm:
        targs.grad_clip_norm = args.grad_clip_norm
    settings = Config(targs)
    settings.trainer = None
    data = build_datasets(targs, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    training = Training(settings, data, program, model, args=targs, device=device)
    # the best-validation cache beside the report, not in the working directory
    training.cache_dir = os.path.join(args.outdir, ".vihds_cache")
    results = training.run()
    if results is None:
        raise SystemExit("recovery_study: training produced no results (NaN abort?)")
    if not torch.isfinite(training.final_params["enc"]["lin"]["w"]).all():
        raise SystemExit(
            "recovery_study: trained encoder parameters are non-finite "
            "(training NaN'd) — no report written; retry with a stronger "
            "--grad_clip_norm or a lower learning rate"
        )

    print("=== 3/3 evaluate on ALL series; compare to truth ===")
    full_host = data.train.dataset.select(np.arange(len(data.train.dataset)))
    merged, _ = training.evaluate(
        training.final_params, full_host, args.test_samples,
        torch.Generator(device=device).manual_seed(args.seed + 1), device=device,
        with_theta=False,
    )
    truth = np.load(truth_path, allow_pickle=True)
    # Score against the theta the data was GENERATED from: the decoder
    # integrates the +-4sigma-clipped draw
    truth_theta = truth["theta_clipped"] if "theta_clipped" in truth else truth["theta"]
    if not np.isfinite(np.asarray(merged["q_mu"])).all():
        raise SystemExit(
            "recovery_study: recovered q is non-finite — no report written"
        )
    rec = dict(
        q_mu=merged["q_mu"],
        q_prec=merged["q_prec"],
        truth_theta=truth_theta,
        theta_names=np.array(program.names, dtype=object),
        iw_predict_mu=merged["iw_predict_mu"],
        iw_predict_std=merged["iw_predict_std"],
        observations=full_host.observations,
    )
    rows, summary = headline(program, rec)
    summary.update(
        val_elbo=float(results.elbo),
        epochs=args.epochs,
        seed=args.seed,
        sigma_scale=args.sigma_scale,
        n_series=int(full_host.observations.shape[0]),
    )
    np.savez(
        os.path.join(args.outdir, "recovery.npz"),
        **rec,
        **{k: v for k, v in summary.items() if v is not None},
    )
    lines = report_lines(args, truth, summary, rows)
    with open(os.path.join(args.outdir, "REPORT.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))
    return summary


def main(argv=None, device="cuda"):
    args = parse(argv)
    check_ported(args)
    from vihds_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    os.environ.setdefault("INFERENCE_RESULTS_DIR",
                          os.path.join(tempfile.gettempdir(), "vihds_tpu_torch_results"))
    out = simulate_stage(args, device)
    return train_and_score(args, out.spec, out.truth, device)


if __name__ == "__main__":
    main()
