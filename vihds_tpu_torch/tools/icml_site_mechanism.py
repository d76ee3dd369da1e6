"""Mechanism probes for the two icml battery sites the TOST gate marks
SHIFTED, aYFP.mu and KGS_81.prec (``tools/icml_site_mechanism.py`` on the
port), each under the port's own decoder:

1. ``ridge``: aYFP rides a compensation ridge through P81 (the RHS only
   constrains aYFP*P81), so per-series posteriors should show strong
   cross-correlations between log aYFP and log e81 / log KGR_81.  Trains
   ``dr_constant_icml`` at the seed, runs the per-series HMC
   (``refine.hmc_refine`` with ``mass_from_q`` and ``adapt_mass``, 16 chains
   x 4000 steps x 10 leapfrog) and writes the per-series posterior
   correlation matrix over ``BLOCK``, averaged over series, to
   ``ridge_seed<N>.npz``.
2. ``drift``: KGS_81 is per-series prior-dominated, so the pooled q
   precision on it should move slowly from its init; trains the same seed
   at several epoch budgets and writes the q(site) trajectory to
   ``drift_seed<N>.npz``.

Usage (on the card; ``main(argv, device="cpu")`` runs on the CPU)::

  python -m vihds_tpu_torch.tools.icml_site_mechanism ridge [seed] [out_dir]
  python -m vihds_tpu_torch.tools.icml_site_mechanism drift [seed] [out_dir] [epochs ...]
"""

import os
import sys

from vihds_tpu_torch.tools import build_out, to_numpy, train

DEFAULT_OUT = build_out("icml_site_ground_truth")
SPEC = "dr_constant_icml.yaml"
BLOCK = ("aYFP", "e81", "KGR_81", "KGS_81", "aCFP", "e76")
#: ``drift``'s epoch budgets where the command line gives none
DRIFT_GRID = (1000, 2000, 4000)


def ridge_summary(trace, n_warmup, program):
    """The per-series posterior correlation matrices over ``BLOCK`` from the
    post-accept trace [S_total, B, K, n_theta] (a tensor or an array), and
    their mean over series: (mean_corr [P, P], corr [B, P, P])."""
    import numpy as np

    idx = [program.index[n] for n in BLOCK]
    d = to_numpy(trace[n_warmup:][..., idx])  # [S, B, K, len(BLOCK)]
    S, B, K, P = d.shape
    # per-series posterior correlation matrix, then series-averaged
    x = d.transpose(1, 0, 2, 3).reshape(B, S * K, P)
    x = x - x.mean(axis=1, keepdims=True)
    cov = np.einsum("bsp,bsq->bpq", x, x) / (S * K - 1)
    sd = np.sqrt(np.maximum(np.einsum("bpp->bp", cov), 1e-30))
    corr = cov / (sd[:, :, None] * sd[:, None, :])
    return corr.mean(axis=0), corr


def ridge(seed, out_dir, device="cuda", epochs=1000, n_chains=16, n_steps=4000, n_leapfrog=10,
          **regime):
    """Probe 1; ``regime``: the training's sample counts (``tools.train``).
    Returns the path of ``ridge_seed<N>.npz``."""
    import numpy as np

    from vihds_tpu_torch import refine

    t = train(SPEC, seed, epochs, device, **regime)
    res = refine.hmc_refine(
        t.model, t.program, t.params, t.batch, seed + 101,
        n_chains=n_chains, n_steps=n_steps, n_leapfrog=n_leapfrog,
        mass_from_q=True, adapt_mass=True, return_trace=True,
    )
    mean_corr, corr = ridge_summary(res.z_trace, int(res.n_warmup), t.program)
    P = len(BLOCK)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ridge_seed%d.npz" % seed)
    np.savez(
        path, block=np.array(BLOCK), mean_corr=mean_corr, corr=corr,
        accept=float(to_numpy(res.accept_rate).mean()),
    )
    print("per-series posterior correlations (mean over %d series):" % corr.shape[0])
    print("%10s" % "", " ".join("%8s" % n for n in BLOCK))
    for i, n in enumerate(BLOCK):
        print("%10s" % n, " ".join("%8.2f" % mean_corr[i, j] for j in range(P)))
    return path


def drift(seed, out_dir, epoch_grid, device="cuda", **regime):
    """Probe 2 over ``epoch_grid``; ``regime`` as ``ridge``'s.  Returns the
    path of ``drift_seed<N>.npz``."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for ep in epoch_grid:
        t = train(SPEC, seed, ep, device, **regime)
        row = {"epochs": ep}
        for s in ("aYFP", "KGS_81"):
            i = t.program.index[s]
            row["%s_q_mu" % s] = float(t.q_mu[:, i].mean())
            row["%s_q_prec" % s] = float(t.q_prec[:, i].mean())
        rows.append(row)
        print(row)
    path = os.path.join(out_dir, "drift_seed%d.npz" % seed)
    np.savez(path, **{k: np.array([r[k] for r in rows]) for k in rows[0]})
    return path


def main(argv=None, device="cuda", **depth):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``); ``depth``:
    ``ridge``'s or ``drift``'s keyword cuts (epochs, chains, steps,
    leapfrog; the training's sample counts)."""
    from vihds_tpu_torch.utils import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0]
    seed = int(argv[1]) if len(argv) > 1 else 0
    out_dir = os.path.abspath(argv[2]) if len(argv) > 2 else DEFAULT_OUT
    if mode == "ridge":
        return ridge(seed, out_dir, resolve_device(device), **depth)
    if mode == "drift":
        grid = [int(e) for e in argv[3:]] or list(DRIFT_GRID)
        return drift(seed, out_dir, grid, resolve_device(device), **depth)
    raise SystemExit("mode must be ridge|drift")


if __name__ == "__main__":
    main()
