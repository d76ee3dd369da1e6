"""aR.mu ground truth on the port (``tools/ar_mu_ground_truth.py``): is a
parity site's offset a small systematic q bias, or basin statistics with a
faithful q?

Per trained seed, the posterior of the sites ``SITES`` under that seed's
own decoder, against the amortised q(site):

  * ``perseries`` (the default): the per-series posteriors by
    ``refine.hmc_refine`` (one independent chain ensemble per series), and
    their KL-barycenter (mean = precision-weighted average of per-series
    posterior means, sd = harmonic-mean posterior sd), which amortised VI
    with per-series ELBO terms targets for a shared site; split-R-hat and
    ESS per series, the barycenter also over the converged series only;
  * ``gibbs`` (``refine.gibbs_refine_pooled``), ``pm``
    (``refine.pm_refine_shared``) and any other value (the pooled joint
    ``refine.hmc_refine_pooled``): the pooled posterior of the shared tier.

Regime: the ctrl_unit battery's (1000 epochs unless ``VIHDS_ARMU_EPOCHS``,
K_train = 200, unit global-q init, the same numpy-seeded split).  Each run
writes ``seed<N>.npz`` with the JAX tool's keys; ``report`` writes its
REPORT.md letter for letter.  ``VIHDS_ARMU_SPEC`` / ``VIHDS_ARMU_SITES``
point it at another spec and sites; ``VIHDS_ARMU_SAMPLER``,
``_LEAPFROG``, ``_INFLATE``, ``_MASSQ``, ``_ADAPTMASS``, ``_PARTICLES`` and
``_RHO`` set the samplers as in the JAX tool.  The whole trace moves to the
host once, after the sampler has run.

Usage (on the card; ``main(argv, device="cpu")`` runs on the CPU)::

  python -m vihds_tpu_torch.tools.ar_mu_ground_truth run <seed> [out_dir] [n_steps]
  python -m vihds_tpu_torch.tools.ar_mu_ground_truth report [out_dir]
"""

import os
import sys

from vihds_tpu_torch.tools import build_out, to_numpy, train

DEFAULT_OUT = build_out("ar_mu_ground_truth")
SITES = tuple(os.environ.get("VIHDS_ARMU_SITES", "aR,aS").split(","))
SPEC = os.environ.get("VIHDS_ARMU_SPEC", "dr_constant_one.yaml")
#: the training's epochs unless ``VIHDS_ARMU_EPOCHS`` says otherwise
EPOCHS = 1000


def split_rhat(x):
    """Split-R-hat over [n_samples, n_chains] draws."""
    import numpy as np

    n = (x.shape[0] // 2) * 2
    halves = np.concatenate([x[: n // 2], x[n // 2: n]], axis=1)  # [n/2, 2C]
    m = halves.shape[1]
    cm = halves.mean(axis=0)
    W = halves.var(axis=0, ddof=1).mean()
    B = halves.shape[0] * cm.var(ddof=1) if m > 1 else 0.0
    var_plus = (halves.shape[0] - 1) / halves.shape[0] * W + B / halves.shape[0]
    return float(np.sqrt(var_plus / max(W, 1e-30)))


def _ess(draws):
    """Effective sample size over [S, K] chains (Geyer initial positive)."""
    S, K = draws.shape
    x = draws - draws.mean(axis=0, keepdims=True)
    # mean autocorrelation across chains
    var = (x ** 2).mean()
    if var <= 0:
        return float(S * K)
    rho_sum = 0.0
    for lag in range(1, min(S - 1, 500)):
        r = (x[:-lag] * x[lag:]).mean() / var
        if r < 0.01:
            break
        rho_sum += r
    return float(S * K / (1.0 + 2.0 * rho_sum))


def perseries_summary(trace, n_warmup, q_mu, q_prec, program):
    """The per-series route's readings of ``SITES`` from the post-accept
    trace [S_total, B, K, n_theta] (warmup included; a tensor or an array):
    (scalars, arrays), the npz's keys beside the run's own."""
    import numpy as np

    ztr_all = to_numpy(trace)                  # [S_tot, B, K, n]
    ztr = ztr_all[n_warmup:]                   # [S, B, K, n]
    out, arrays = {}, {}
    q_sd_all = 1.0 / np.sqrt(q_prec)
    for name in SITES:
        i = program.index[name]
        d = ztr[:, :, :, i]                    # [S, B, K]
        mu_s = d.mean(axis=(0, 2))             # per-series posterior means
        var_s = d.var(axis=(0, 2))             # per-series posterior vars
        w = 1.0 / np.maximum(var_s, 1e-12)
        bary = float((w * mu_s).sum() / w.sum())
        bary_sd = float(np.sqrt(d.shape[1] / w.sum()))  # harmonic-mean sd
        # per-series chain diagnostics; the gate uses the WORST series
        rhats, esss, mcses = [], [], []
        for b in range(d.shape[1]):
            db = d[:, b, :]                    # [S, K]
            rhats.append(split_rhat(db))
            e = _ess(db)
            esss.append(e)
            mcses.append(float(db.std() / max(np.sqrt(e), 1.0)))
        w_n = w / w.sum()
        out["%s_q_mu" % name] = float(q_mu[:, i].mean())
        out["%s_q_sd" % name] = float(q_sd_all[:, i].mean())
        out["%s_hmc_mean" % name] = bary
        out["%s_hmc_sd" % name] = bary_sd
        out["%s_hmc_mcse" % name] = float(
            np.sqrt((w_n ** 2 * np.asarray(mcses) ** 2).sum())
        )
        out["%s_rhat" % name] = float(np.max(rhats))
        out["%s_hmc_ess" % name] = float(np.min(esss))
        # the ensemble mean over the whole trace, warmup included: the
        # report's stationarity drift reads its first 5 %
        arrays["%s_ens_mu" % name] = ztr_all[:, :, :, i].mean(axis=(1, 2))
        arrays["%s_series_mu" % name] = mu_s
        arrays["%s_series_sd" % name] = np.sqrt(var_s)
        arrays["%s_series_rhat" % name] = np.asarray(rhats)
        arrays["%s_series_ess" % name] = np.asarray(esss)
        # barycenter restricted to converged series (sensitivity check:
        # a few non-mixed series must not be what moves the verdict)
        okb = (np.asarray(rhats) < 1.05) & (np.asarray(esss) >= 100)
        if okb.any():
            out["%s_hmc_mean_conv" % name] = float(
                (w[okb] * mu_s[okb]).sum() / w[okb].sum()
            )
            # barycenter sd over converged series (prec-moment yardstick:
            # q* precision = mean of per-series posterior precisions)
            out["%s_hmc_sd_conv" % name] = float(
                np.sqrt(okb.sum() / w[okb].sum())
            )
            out["%s_n_conv" % name] = int(okb.sum())
    return out, arrays


def pooled_summary(trace, n_warmup, q_mu, q_prec, program):
    """The pooled routes' readings of ``SITES`` from the conditioned tier's
    trace [S_total, D, K, nC] (warmup included): (scalars, arrays)."""
    import numpy as np

    tc_all = to_numpy(trace)  # [S_total, D, K, nC] incl. warmup
    tc = tc_all[n_warmup:]    # [S, D, K, nC]
    csl = program.global_cond_slice
    gc_names = [program.names[i] for i in range(csl.start, csl.stop)]
    out, arrays = {}, {}
    for name in SITES:
        i = program.index[name]
        ic = i - csl.start
        if gc_names[ic] != name:
            raise ValueError("%s is not a global_conditioned site" % name)
        draws = tc[:, 0, :, ic]  # [S, K] z-space (z = log theta for LogNormal)
        out["%s_q_mu" % name] = float(q_mu[:, i].mean())
        out["%s_q_sd" % name] = float((1.0 / np.sqrt(q_prec[:, i])).mean())
        out["%s_hmc_mean" % name] = float(draws.mean())
        out["%s_hmc_sd" % name] = float(draws.std())
        # MCSE via ESS from lag-1..L autocorrelation of the pooled chains
        ac = _ess(draws)
        out["%s_hmc_ess" % name] = ac
        out["%s_hmc_mcse" % name] = float(draws.std() / max(np.sqrt(ac), 1.0))
        out["%s_rhat" % name] = split_rhat(draws)
        # ensemble-stationarity diagnostic: chains start AT q, and the kernel
        # leaves the exact posterior invariant, so a systematic drift of the
        # cross-chain ensemble mean away from q's mean exposes a q bias
        arrays["%s_ens_mu" % name] = tc_all[:, 0, :, ic].mean(axis=1)
    return out, arrays


def _env(name, default, kind=int):
    return kind(os.environ.get("VIHDS_ARMU_" + name, default))


def run(seed, out_dir, n_steps=3000, device="cuda", n_chains=16, **regime):
    """Train ``SPEC`` at ``seed`` (``regime``: the training's sample counts,
    ``tools.train``), sample with ``VIHDS_ARMU_SAMPLER``'s route and write
    ``out_dir``/seed<N>.npz; returns its path."""
    import numpy as np

    from vihds_tpu_torch import refine

    os.makedirs(out_dir, exist_ok=True)
    t = train(SPEC, seed, _env("EPOCHS", EPOCHS), device, **regime)
    model, program, params, batch = t.model, t.program, t.params, t.batch
    sampler = os.environ.get("VIHDS_ARMU_SAMPLER", "perseries")
    if sampler == "perseries":
        # the matched yardstick: the KL-barycenter of the per-series
        # posteriors, each sampled by its own chains
        res = refine.hmc_refine(
            model, program, params, batch, seed + 101,
            n_chains=n_chains, n_steps=int(n_steps),
            n_leapfrog=_env("LEAPFROG", "5"),
            init_inflate=_env("INFLATE", "1.0", float),
            mass_from_q=bool(_env("MASSQ", "0")),
            adapt_mass=bool(_env("ADAPTMASS", "0")),
            return_trace=True,
        )
        trace, summary = res.z_trace, perseries_summary
    elif sampler == "gibbs":
        # exact-joint Gibbs: locals by per-series HMC given shared, shared
        # by adaptive MH given locals
        res = refine.gibbs_refine_pooled(
            model, program, params, batch, seed + 101,
            devices=t.host.devices, n_chains=n_chains, n_sweeps=int(n_steps),
            n_leapfrog=_env("LEAPFROG", "10"),
            return_trace=True,
        )
        trace, summary = res.state_trace["c"], pooled_summary
    elif sampler == "pm":
        # correlated pseudo-marginal MH over the shared tier, the locals
        # integrated out by importance sampling from the trained q
        res = refine.pm_refine_shared(
            model, program, params, batch, seed + 101,
            devices=t.host.devices, n_chains=n_chains, n_steps=int(n_steps),
            n_particles=_env("PARTICLES", "64"),
            rho=_env("RHO", "0.98", float),
            return_trace=True,
        )
        trace, summary = res.state_trace["c"], pooled_summary
    else:
        res = refine.hmc_refine_pooled(
            model, program, params, batch, seed + 101,
            devices=t.host.devices, n_chains=n_chains, n_steps=int(n_steps),
            n_leapfrog=_env("LEAPFROG", "16"),
            step_scale=0.1, mass_from_q=True, return_trace=True,
        )
        trace, summary = res.state_trace["c"], pooled_summary
    out = {
        "seed": seed,
        "best_val_elbo": float(np.asarray(t.results.elbo)) if t.results is not None else np.nan,
        "accept": float(to_numpy(res.accept_rate).mean()),
        "n_steps": int(n_steps),
        "sampler": sampler,
    }
    if "accept_rate_u" in res:
        out["accept_u"] = float(to_numpy(res.accept_rate_u).mean())
    scalars, arrays = summary(trace, int(res.n_warmup), t.q_mu, t.q_prec, program)
    out.update(scalars)
    path = os.path.join(out_dir, "seed%d.npz" % seed)
    np.savez(path, **out, **arrays)
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()})
    print("saved", path)
    return path


def report(out_dir):
    import glob

    import numpy as np

    lines = [
        "# %s ground truth: q vs the per-series-posterior KL-barycenter, per trained seed"
        % "/".join(SITES),
        "",
        ("Regime: %s, 1000 ep, K=200, unit " % SPEC) +
        "init; values in z-space (z = log theta).  Yardstick: amortised "
        "VI with per-series ELBO terms targets, for a shared site, the "
        "KL-barycenter of the per-series posteriors (mean = "
        "precision-weighted average of per-series posterior means, sd = "
        "harmonic-mean posterior sd), NOT the pooled posterior — so each "
        "seed's q(site) is compared against the barycenter of exact "
        "per-series HMC posteriors under that seed's OWN decoder "
        "(refine.hmc_refine, one independent chain per series; R-hat is "
        "the WORST series, ESS the SMALLEST).  aS is the "
        "identically-specified control site that PASSES the "
        "cross-implementation battery.  (The pooled posterior is both the "
        "wrong target and intractable here: joint HMC split-R-hat ~22, "
        "Gibbs conditional-crawl ~55, pseudo-marginal IS noise 20+ nats — "
        "see REPORT history.)",
        "",
        "| seed | site | q mu | q sd | HMC bary (all) | bary (converged series) +- MCSE | HMC sd | |q-conv|/HMC sd | q sd / bary sd (conv) | n_conv | worst R-hat | min ESS |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    gaps = {s: [] for s in SITES}
    n_series_note = None
    for path in sorted(glob.glob(os.path.join(out_dir, "seed*.npz"))):
        z = np.load(path)
        for s in SITES:
            # Convergence gate is PER SERIES, not per seed: the verdict
            # barycenter uses only series with split-R-hat < 1.05 and
            # ESS >= 100 (*_hmc_mean_conv, computed at run time); a seed is
            # excluded only if NO series converged.
            conv_key = "%s_hmc_mean_conv" % s
            has_conv = conv_key in z.files
            mean_conv = float(z[conv_key]) if has_conv else np.nan
            n_conv = int(z["%s_n_conv" % s]) if has_conv else 0
            n_total = (
                len(np.asarray(z["%s_series_rhat" % s]))
                if "%s_series_rhat" % s in z.files else None
            )
            if n_total is not None:
                n_series_note = n_total
            gap = abs(float(z["%s_q_mu" % s]) - mean_conv)
            rel = gap / max(float(z["%s_hmc_sd" % s]), 1e-12)
            sd_conv_key = "%s_hmc_sd_conv" % s
            sd_ratio = (
                float(z["%s_q_sd" % s]) / max(float(z[sd_conv_key]), 1e-12)
                if sd_conv_key in z.files else np.nan
            )
            if has_conv:
                gaps[s].append((gap, rel, n_conv, sd_ratio))
            lines.append(
                "| %d | %s | %.3f | %.3f | %.3f | %s +- %.3f | %.3f | %s | %s | %s | %.3f | %.0f |%s"
                % (int(z["seed"]), s, z["%s_q_mu" % s], z["%s_q_sd" % s],
                   z["%s_hmc_mean" % s],
                   ("%.3f" % mean_conv) if has_conv else "—",
                   z["%s_hmc_mcse" % s], z["%s_hmc_sd" % s],
                   ("%.2f" % rel) if has_conv else "—",
                   ("%.2f" % sd_ratio) if np.isfinite(sd_ratio) else "—",
                   "%d%s" % (n_conv, "/%d" % n_total if n_total else ""),
                   z["%s_rhat" % s], z["%s_hmc_ess" % s],
                   "" if has_conv else " GATE-FAIL (no converged series; excluded)")
            )
    lines.append("")
    if n_series_note:
        lines.append(
            "Gate: per-series (split-R-hat < 1.05 and ESS >= 100 per series' "
            "chain ensemble); the verdict column 'bary (converged series)' is "
            "the precision-weighted barycenter over ONLY the converged "
            "series.  The all-series barycenter is kept for comparison; "
            "where the two agree, the non-mixed series are not driving the "
            "verdict."
        )
        lines.append("")
    for s in SITES:
        if not gaps[s]:
            continue
        rels = [r for _, r, _, _ in gaps[s]]
        sdr = [x for _, _, _, x in gaps[s] if np.isfinite(x)]
        lines.append(
            "%s: mean |q - converged-series barycenter| = %.3f (%.2f posterior "
            "sd, converged series only; mean n_conv %.1f%s); "
            "cross-implementation battery shift for comparison: 0.57 (aR)."
            % (s, float(np.mean([g for g, _, _, _ in gaps[s]])),
               float(np.mean(rels)), float(np.mean([n for _, _, n, _ in gaps[s]])),
               ("; mean q-sd/bary-sd %.2f" % float(np.mean(sdr))) if sdr else "")
        )
    # Ensemble-stationarity drift: chains start AT q and the kernel leaves
    # the exact posterior invariant, so if q matched the posterior the
    # cross-chain ensemble mean would be flat (in expectation) at every
    # step; the raw late-window sd is quoted as its spread.
    drift_lines = [
        "",
        "## Ensemble-stationarity drift (per seed, z-space)",
        "",
        "| seed | site | q mu | ens mean (first 5%) | ens mean (last 20%) | late sd(ens) | drift / HMC sd |",
        "|---|---|---|---|---|---|---|",
    ]
    have_any = False
    for path in sorted(glob.glob(os.path.join(out_dir, "seed*.npz"))):
        z = np.load(path)
        for s in SITES:
            key = "%s_ens_mu" % s
            if key not in z.files:
                continue
            have_any = True
            ens = np.asarray(z[key])
            n = ens.shape[0]
            early = float(ens[: max(n // 20, 1)].mean())
            late_w = ens[-max(n // 5, 1):]
            late = float(late_w.mean())
            drift = (late - float(z["%s_q_mu" % s])) / max(float(z["%s_hmc_sd" % s]), 1e-12)
            drift_lines.append(
                "| %d | %s | %.3f | %.3f | %.3f | %.3f | %+.2f |"
                % (int(z["seed"]), s, z["%s_q_mu" % s], early, late,
                   float(late_w.std()), drift)
            )
    if have_any:
        lines.extend(drift_lines)
    report_path = os.path.join(out_dir, "REPORT.md")
    with open(report_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print("written to", report_path)
    return report_path


def main(argv=None, device="cuda", **depth):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``); ``depth``:
    ``run``'s ``n_chains`` and the training's sample counts."""
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0]
    if mode == "report":
        return report(os.path.abspath(argv[1]) if len(argv) > 1 else DEFAULT_OUT)
    from vihds_tpu_torch.utils import resolve_device

    seed = int(argv[1])
    out_dir = os.path.abspath(argv[2]) if len(argv) > 2 else DEFAULT_OUT
    n_steps = int(argv[3]) if len(argv) > 3 else 3000
    return run(seed, out_dir, n_steps, resolve_device(device), **depth)


if __name__ == "__main__":
    main()
