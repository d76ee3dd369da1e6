"""Posterior-moment parity gate on the port (``tools/posterior_parity.py``'s
``ours`` and ``compare`` modes).

``ours`` trains one split of a spec as ``run_xval.run_on_split`` does
(``make_training``, then ``Training.run`` with its best-validation cache in
a temporary directory) at the gate's regime (K_train = 200, K_eval = ``VIHDS_REF_TEST_SAMPLES`` or
200, an evaluation every ``VIHDS_REF_TEST_EPOCH`` or 20 epochs, the global
q init ``VIHDS_OURS_Q_INIT`` where set) and saves the best-validation q-site
moments and predictive moments as ``ours_seed<N>.npz``, the JAX tool's
keys, dtypes and object arrays (a run whose ELBO diverged goes under
``diverged/``).  ``compare`` writes REPORT.md: on one directory the JAX
tool's report letter for letter (its ``reference_seed*`` against its
``ours_seed*``); with ``--against DIR`` the port's ``ours_seed*`` of
``out_dir`` against the ``<against_tag>_seed*`` recorded in DIR (read
only), the report written into ``out_dir``.  The JAX tool's ``reference``
mode, which runs the original reference implementation, is not here: its
recorded npz stand in.

Usage (on the card; ``main(argv, device="cpu")`` runs on the CPU)::

  python -m vihds_tpu_torch.tools.posterior_parity ours <seed> [epochs] [out_dir] [spec]
  python -m vihds_tpu_torch.tools.posterior_parity compare [out_dir] [spec_label]
      [--against DIR] [--against_tag reference|ours]
"""

import os
import sys

from vihds_tpu_torch.tools import TRAIN_SAMPLES, build_out, run_training, training_args

DEFAULT_OUT = build_out("posterior_parity")
DEFAULT_SPEC = "dr_constant_one.yaml"
DEFAULT_EPOCHS = 300

# A run's ELBO above this is the reference's +-4sigma clip exploit blowing up
# (q pushed past the clip bound => unbounded -log q); its best-val cache is
# then the exploded epoch — junk moments.
DIVERGED_ELBO = 1e4

#: what a recorded directory's tags hold
SIDES = {"reference": "the reference (torch CPU)", "ours": "the JAX package (vihds_tpu)"}


def _save(out_dir, tag, seed, results):
    import numpy as np

    elbo = results.elbo
    if not float(elbo) == float(elbo) or abs(float(elbo)) > DIVERGED_ELBO:
        out_dir = os.path.join(out_dir, "diverged")  # outside compare()'s glob
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "%s_seed%d.npz" % (tag, seed))
    # allow_pickle goes into the file as an array of its own, as the JAX
    # tool's npz hold it
    np.savez(
        path,
        q_names=np.array(list(results.q_names), dtype=object),
        q_values=np.array(
            [np.asarray(v, dtype=np.float64) for v in results.q_values], dtype=object
        ),
        elbo=float(elbo),
        # posterior-predictive moments on the validation set [n_val, 4, T] —
        # the parameterisation-independent face of the posterior
        iw_predict_mu=np.asarray(results.iw_predict_mu, dtype=np.float64),
        iw_predict_std=np.asarray(results.iw_predict_std, dtype=np.float64),
        allow_pickle=True,
    )
    print("saved %s (best-val elbo %.2f)" % (path, float(elbo)))
    return path


def run_ours(seed, epochs, out_dir, spec, device="cuda", train_samples=TRAIN_SAMPLES):
    """Train ``spec`` at ``seed`` for ``epochs`` and save ``ours_seed<N>.npz``
    under ``out_dir``; returns its path."""
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.run_xval import make_training

    args = training_args(
        spec, seed, epochs, train_samples=train_samples,
        test_samples=int(os.environ.get("VIHDS_REF_TEST_SAMPLES", "200")),
        test_epoch=int(os.environ.get("VIHDS_REF_TEST_EPOCH", "20")))
    settings = Config(args)
    settings.trainer = None
    if os.environ.get("VIHDS_OURS_Q_INIT"):
        # init-convention control: "unit" matches the reference's Q_Global
        # log-prec=0 init (see config.DEFAULT_PARAMS["q_global_init"])
        settings.params.q_global_init = os.environ["VIHDS_OURS_Q_INIT"]
        print("[posterior_parity] ours q_global_init = %s" % settings.params.q_global_init)
    _, training = make_training(args, settings, device=device)
    return _save(out_dir, "ours", seed, run_training(training))


def _collect(out_dir, tag):
    import glob

    import numpy as np

    runs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "%s_seed*.npz" % tag))):
        with np.load(path, allow_pickle=True) as z:
            runs.append(
                (
                    list(z["q_names"]),
                    list(z["q_values"]),
                    float(z["elbo"]),
                    np.asarray(z["iw_predict_mu"]) if "iw_predict_mu" in z else None,
                )
            )
    if not runs:
        raise SystemExit("no %s_seed*.npz under %s" % (tag, out_dir))
    return runs


def compare(out_dir, spec_label="dr_constant_one", against=None, against_tag="reference"):
    """Write ``out_dir``/REPORT.md: ``out_dir``'s ``reference_seed*`` against
    its ``ours_seed*``, or, with ``against``, that directory's
    ``<against_tag>_seed*`` against the port's ``ours_seed*`` of
    ``out_dir``; returns the report's text."""
    import numpy as np

    if against is None:
        ref_runs = _collect(out_dir, "reference")
        title = "# Posterior-moment parity: reference (torch CPU) vs this repo"
        cols = ("ref", "ours")
    else:
        ref_runs = _collect(against, against_tag)
        title = ("# Posterior-moment parity: %s, recorded in %s (%s_seed*), vs the PyTorch "
                 "port (vihds_tpu_torch, ours_seed* in %s)"
                 % (SIDES[against_tag], against, against_tag, out_dir))
        cols = (against_tag, "port")
    our_runs = _collect(out_dir, "ours")
    names = ref_runs[0][0]
    assert names == our_runs[0][0], "q-site name sets differ"

    def stack(runs, i):
        return np.stack([np.atleast_1d(np.asarray(r[1][i], dtype=np.float64)) for r in runs])

    lines = [
        title,
        "",
        "Spec %s, matched regime (epochs, K, LR schedule), %d+%d seeds."
        % (spec_label, len(ref_runs), len(our_runs)),
        "Same numpy-seeded split => local sites compare elementwise over the",
        "validation datapoints.  z = |mean_%s - mean_%s| / sqrt(se_%s^2 + se_%s^2)"
        % (cols[0], cols[1], cols[0], cols[1]),
        "with se the across-seed standard error; 'pass' = median z over elements <= 3.",
        "",
        "| site tensor | arity | mean (%s) | mean (%s) | median z | max z | pass |" % cols,
        "|---|---|---|---|---|---|---|",
    ]
    n_pass = n_tot = 0
    for i, name in enumerate(names):
        if name.endswith(".value"):
            continue  # constants
        R = stack(ref_runs, i)  # [seeds, arity]
        O = stack(our_runs, i)
        if R.shape[1] != O.shape[1]:
            lines.append("| %s | shape mismatch %s vs %s | | | | | FAIL |" % (name, R.shape, O.shape))
            n_tot += 1
            continue
        mr, mo = R.mean(0), O.mean(0)
        se = np.sqrt(R.var(0, ddof=1) / R.shape[0] + O.var(0, ddof=1) / O.shape[0])
        z = np.abs(mr - mo) / np.maximum(se, 1e-12)
        ok = float(np.median(z)) <= 3.0
        n_pass += ok
        n_tot += 1
        lines.append(
            "| %s | %d | %.4f | %.4f | %.2f | %.2f | %s |"
            % (name, R.shape[1], mr.mean(), mo.mean(), np.median(z), z.max(), "yes" if ok else "NO")
        )
    side = ("reference", "ours") if against is None else (against_tag, "port")
    lines += [
        "",
        "**%d / %d site tensors within MC error (median z <= 3).**" % (n_pass, n_tot),
        "",
        "Best-val ELBO per seed — %s: %s; %s: %s"
        % (side[0], [round(r[2], 1) for r in ref_runs], side[1], [round(r[2], 1) for r in our_runs]),
        "",
    ]

    # Posterior-predictive parity: the parameterisation-independent face of
    # the posterior (q-precision sites at this horizon mostly reflect each
    # implementation's INIT convention), so the predictive comparison is the
    # decisive correctness check.
    if ref_runs[0][3] is not None and our_runs[0][3] is not None:
        Rp = np.stack([r[3] for r in ref_runs])  # [seeds, n_val, 4, T]
        Op = np.stack([r[3] for r in our_runs])
        if Rp.shape[1:] == Op.shape[1:]:
            mr, mo = Rp.mean(0), Op.mean(0)
            se = np.sqrt(Rp.var(0, ddof=1) / Rp.shape[0] + Op.var(0, ddof=1) / Op.shape[0])
            z = np.abs(mr - mo) / np.maximum(se, 1e-12)
            scale = np.maximum(np.abs(mr).max(axis=(0, 2), keepdims=True), 1e-12)
            rel = np.abs(mr - mo) / scale
            lines += [
                "## Posterior-predictive parity (validation set, %d series x 4 signals x %d times)"
                % mr.shape[::2],
                "",
                "| signal | median z | 90th pct z | median rel err | max rel err |",
                "|---|---|---|---|---|",
            ]
            for s, sig in enumerate(["OD", "mRFP1", "EYFP", "ECFP"]):
                zs, rs = z[:, s, :], rel[:, s, :]
                lines.append(
                    "| %s | %.2f | %.2f | %.4f | %.4f |"
                    % (sig, np.median(zs), np.percentile(zs, 90), np.median(rs), rs.max())
                )
            ok_pred = float(np.median(z)) <= 3.0
            lines += [
                "",
                "**Predictive means %s within MC error (overall median z = %.2f; "
                "median relative error = %.4f).**"
                % ("agree" if ok_pred else "DISAGREE", np.median(z), np.median(rel)),
                "",
            ]
        else:
            lines += ["(predictive shapes differ: %s vs %s)" % (Rp.shape, Op.shape), ""]
    report = "\n".join(lines)
    out = os.path.join(out_dir, "REPORT.md")
    with open(out, "w") as f:
        f.write(report)
    print(report)
    print("written to", out)
    return report


def main(argv=None, device="cuda", train_samples=TRAIN_SAMPLES):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``);
    ``train_samples`` cuts K_train of ``ours``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0]
    if mode == "compare":
        import argparse

        p = argparse.ArgumentParser(prog="posterior_parity compare")
        p.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
        p.add_argument("spec_label", nargs="?", default="dr_constant_one")
        p.add_argument("--against", default=None,
                       help="a recorded directory whose <against_tag>_seed*.npz the port's "
                       "ours_seed*.npz of out_dir are compared with (read only)")
        p.add_argument("--against_tag", default="reference", choices=sorted(SIDES))
        a = p.parse_args(argv[1:])
        return compare(a.out_dir, a.spec_label, a.against, a.against_tag)
    if mode != "ours":
        raise SystemExit("mode must be ours|compare (the reference mode runs the original "
                         "reference: tools/posterior_parity.py)")
    from vihds_tpu_torch.utils import resolve_device

    seed = int(argv[1])
    epochs = int(argv[2]) if len(argv) > 2 else DEFAULT_EPOCHS
    out_dir = os.path.abspath(argv[3] if len(argv) > 3 else DEFAULT_OUT)
    spec = argv[4] if len(argv) > 4 else DEFAULT_SPEC
    return run_ours(seed, epochs, out_dir, spec, resolve_device(device), train_samples)


if __name__ == "__main__":
    main()
