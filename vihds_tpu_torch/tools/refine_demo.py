"""Posterior-refinement demo on a trained model (``tools/refine_demo.py``
on the port).

Restores trained parameters from a run's checkpoints (the port's own
``<epoch>.pt``, ``vihds_tpu_torch.checkpoint``), then sharpens the
amortised posterior with annealed SMC and HMC on the first test series,
reporting the per-datapoint SMC log-evidence against the amortised IWAE
bound.  Under a spec's ``solver: pallas_midpoint`` every evaluation runs
the fused ``dr_fwd`` kernel and every gradient ``dr_bwd``.

Usage (on the card; ``main(argv, device="cpu")`` runs on the CPU)::

  python -m vihds_tpu_torch.tools.refine_demo <checkpoints_dir> [spec] [n_particles]

``spec`` is joined to the repository's root (an absolute path whole).
"""

import math
import os
import sys

from vihds_tpu_torch.config import _REPO

#: the JAX tool's depth: SMC temperatures and moves, HMC steps, the series
N_TEMPS = 16
N_MOVES = 2
N_STEPS = 60
MAX_SERIES = 12
#: the JAX tool's PRNGKey(7)
SEED = 7


def refine(model, program, params, batch, draws, n_particles, n_temps=N_TEMPS,
           n_moves=N_MOVES, n_steps=N_STEPS):
    """The amortised IWAE bound at K = ``n_particles``, then ``smc_refine``
    and ``hmc_refine`` on ``batch``.  ``draws``: a source of draws
    (``refine.as_draws``: an integer seed, or an object with ``normal`` /
    ``uniform`` / ``gumbel``) that the three stages take in turn, or a dict
    of them by stage, ``"iwae"``, ``"smc"`` and ``"hmc"``.  Returns (IWAE
    bound per series, the SMC result, the HMC result)."""
    import torch

    from vihds_tpu_torch import refine as R
    from vihds_tpu_torch.training import iwae_elbo_terms

    device = batch.observations.device
    if not isinstance(draws, dict):
        shared = R.as_draws(draws, device)
        draws = dict.fromkeys(("iwae", "smc", "hmc"), shared)
    n = batch.observations.shape[0]
    with torch.no_grad():
        u = R.as_draws(draws["iwae"], device).normal("u", (n, n_particles, model.n_theta))
        out = model.forward(params, batch, u.to(device))
        terms = iwae_elbo_terms(program, out, batch, model.use_laplace)
        iwae = torch.logsumexp(terms.log_w, dim=1) - math.log(n_particles)
    smc = R.smc_refine(model, program, params, batch, draws["smc"], n_particles=n_particles,
                       n_temps=n_temps, n_moves=n_moves)
    hmc = R.hmc_refine(model, program, params, batch, draws["hmc"], n_chains=n_particles,
                       n_steps=n_steps)
    return iwae, smc, hmc


def report(n, iwae, smc, hmc):
    """The JAX tool's lines; returns the numbers they print."""
    from vihds_tpu_torch.tools import to_numpy

    iwae = to_numpy(iwae)
    log_z = to_numpy(smc.log_evidence)
    accept = float(to_numpy(hmc.accept_rate).mean())
    lj = to_numpy(hmc.log_joint_trace)
    print("\nper-datapoint bounds (first %d validation series):" % n)
    print("  amortised IWAE:  mean %9.2f" % iwae.mean())
    print("  SMC log-evidence: mean %9.2f  (tighter by %.2f nats/datapoint)"
          % (log_z.mean(), (log_z - iwae).mean()))
    print("  HMC accept rate:  %.2f (post-warmup mean)" % accept)
    print("  HMC median log-joint: start %.1f -> end %.1f" % (lj[0], lj[-1]))
    return dict(iwae=float(iwae.mean()), log_evidence=float(log_z.mean()),
                tighter=float((log_z - iwae).mean()), accept=accept,
                log_joint_start=float(lj[0]), log_joint_end=float(lj[-1]))


def main(argv=None, device="cuda", **depth):
    """``argv`` as the JAX tool's (default ``sys.argv[1:]``); ``depth``:
    ``refine``'s ``n_temps``, ``n_moves``, ``n_steps``.  Returns the printed
    numbers."""
    import numpy as np
    import torch

    from vihds_tpu_torch import checkpoint as ckpt
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.run_xval import create_parser
    from vihds_tpu_torch.training import batch_tensors
    from vihds_tpu_torch.utils import resolve_device
    from vihds_tpu_torch.vae import VAE, params_to

    argv = sys.argv[1:] if argv is None else list(argv)
    ckpt_dir = argv[0]
    spec = os.path.join(_REPO, argv[1] if len(argv) > 1 else "specs/dr_constant_icml.yaml")
    n_particles = int(argv[2]) if len(argv) > 2 else 64
    device = resolve_device(device)

    args = create_parser(True).parse_args([spec])
    args.seed = 0
    settings = Config(args)
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)

    step, state = ckpt.restore(ckpt_dir)
    if state is None:
        raise SystemExit("no checkpoint under %s" % ckpt_dir)
    params = params_to(state["params"], device)
    print("restored params from epoch %s" % step)

    n = min(MAX_SERIES, data.n_test)
    host = data.test.dataset.select(data.test.indices[:n])
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(host, np.arange(n), times, device)
    return report(n, *refine(model, program, params, batch, SEED, n_particles, **depth))


if __name__ == "__main__":
    main()
