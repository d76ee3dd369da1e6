"""Clip-exploit activity in trained posteriors (``tools/clip_activity.py``
on the port).

The reference evaluates log q and log p at the *clipped* theta.  Whenever
the trained q places mass beyond the +-4-sigma prior clip bound, every such
sample is pinned at the bound while -log q(clipped) keeps growing: the
readout is inflated relative to the true IWAE bound.  Both packages score
log q / log p at the sampled theta, identical whenever clipping is inactive.

For each saved parity run (``posterior_parity`` npz, ``reference_seed*``
and ``ours_seed*``) this prints how much q mass lies beyond the clip
bounds: for site i with variational moments (m, s) and prior (m0, s0), the
escaped mass is  Phi((lo-m)/s) + 1 - Phi((hi-m)/s)  with [lo, hi] =
m0 -+ 4 s0.  The prior moments come from the port's ``ParamProgram`` of
the spec; nothing runs on a device.

Usage: python -m vihds_tpu_torch.tools.clip_activity [out_dir] [spec]
"""

import glob
import math
import os
import sys

from vihds_tpu_torch.tools import build_out, spec_path

DEFAULT_OUT = build_out("posterior_parity")


def phi(x):
    """The standard normal CDF, elementwise."""
    import numpy as np

    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def clip_activity(out_dir, spec_name):
    """Print the table for the runs under ``out_dir``."""
    import numpy as np

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.run_xval import create_parser

    args = create_parser(True).parse_args([spec_path(spec_name)])
    settings = Config(args)
    prog = ParamProgram(parse_parameters(settings.params))
    pq = prog.prior_q()
    prior_mu = pq.mu.numpy()[0]
    prior_sig = 1.0 / np.sqrt(pq.prec.numpy()[0])
    site_index = {s.name: i for i, s in enumerate(prog.sites.ordered)}

    print("| run | mean escaped q-mass | max escaped q-mass | worst site |")
    print("|---|---|---|---|")
    for tag in ("reference", "ours"):
        for path in sorted(glob.glob(os.path.join(out_dir, "%s_seed*.npz" % tag))):
            with np.load(path, allow_pickle=True) as z:
                names = [str(n) for n in z["q_names"]]
                vals = [np.asarray(v, np.float64) for v in z["q_values"]]
            mus = {n[:-3]: v for n, v in zip(names, vals) if n.endswith(".mu")}
            precs = {n[:-5]: v for n, v in zip(names, vals) if n.endswith(".prec")}
            rows = []
            for site, m in mus.items():
                if site not in precs or site not in site_index:
                    continue
                i = site_index[site]
                if not np.isfinite(prior_sig[i]) or prior_sig[i] <= 0:
                    continue  # constants
                s = 1.0 / np.sqrt(np.maximum(precs[site], 1e-12))
                lo = prior_mu[i] - 4.0 * prior_sig[i]
                hi = prior_mu[i] + 4.0 * prior_sig[i]
                esc = phi((lo - m) / s) + 1.0 - phi((hi - m) / s)
                rows.append((site, float(np.mean(esc)), float(np.max(esc))))
            mean_esc = float(np.mean([r[1] for r in rows]))
            worst = max(rows, key=lambda r: r[2])
            print(
                "| %s | %.4f | %.4f | %s |"
                % (os.path.basename(path)[:-4], mean_esc, worst[2], worst[0])
            )


def main(argv=None, device="cuda"):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``); ``device`` is
    unused (nothing runs on a device)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if argv else DEFAULT_OUT
    spec = argv[1] if len(argv) > 1 else "dr_constant_one.yaml"
    clip_activity(out, spec)


if __name__ == "__main__":
    main()
