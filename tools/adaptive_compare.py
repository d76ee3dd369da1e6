"""Time the adaptive integrator (``vihds_tpu_torch.ops.dopri``) against
other versions of it, on phase 19's configuration of ``chip_smoke.py``.

``dr_constant_icml`` under ``solver: dopri5`` (the continuous adjoint), its
first CSV, params from seed 0, a training batch of B=36 series and a draw u
of K=200 samples (phase 19's sizes).  For each version, in the order
ref(s), change, change, ref(s) reversed (to read drift across the call):
the wall of one forward (``dopri.integrate_adaptive`` on the step's
operands, no sync but the last; median of ``--reps``) and of one training
step (``training.loss_fn`` and its backward; median of ``--reps``), its
attempted steps (its right-hand side's calls over 7), and whether its
trajectory, loss and gradients equal the first version's bit for bit.  A version is this checkout's module (``change``) or
a ``dopri.py`` of another checkout (``--ref NAME=PATH``); the adjoint calls
whichever ``dopri.integrate_adaptive`` is in place.  Prints one line a run
and a JSON line.

    python3 tools/adaptive_compare.py --ref parent=build/parent/vihds_tpu_torch/ops/dopri.py
    python3 tools/adaptive_compare.py --device cpu --samples 4 --reps 1   # a quick check

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: dopri5's right-hand side calls an attempted step
STAGES = 7


def _load(name, path):
    spec = importlib.util.spec_from_file_location("dopri_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _setup(device, samples):
    """(model, program, params, batch, mask, u, times) at phase 19's sizes."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.training import batch_tensors
    from vihds_tpu_torch.vae import VAE

    args, settings = cs.training_settings(cs.ADAPTIVE_SOLVER, cs.SPEC, cs.ADAPTIVE_FLAGS)
    settings.data.files = settings.data.files[:cs.ADAPTIVE_FILES]
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(torch.Generator().manual_seed(cs.SEED), device=device)
    host = data.train.batch()
    B = settings.params.n_batch
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(host, np.arange(B), times, device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 7)
    u = model.sample_u(gen, B, samples, device)
    return model, program, params, batch, torch.ones(B, device=device), u, times


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _run(version, setup, device, reps):
    """One version's readings: forward and step walls, steps, outputs."""
    import torch

    from vihds_tpu_torch import training
    from vihds_tpu_torch.ops import dopri

    model, program, params, batch, mask, u, times = setup
    ode = model.ode_model
    with torch.no_grad():
        q = model.encoder(params["enc"], batch)
        th = program.theta_dict(program.clip(program.sample(q, u)))
        th = ode.condition_theta(params["dec"], th, batch.dev_1hot)
        y0 = ode.initialize_state(params["dec"], th, batch.inputs, u.shape[0], u.shape[1])
        plain_rhs = ode.make_rhs(params["dec"], th, batch.inputs, batch.dev_1hot)
        calls = []

        def rhs(t, y):
            calls.append(1)
            return plain_rhs(t, y)

        fwd = []
        for _ in range(reps):
            calls.clear()
            _sync(device)
            t0 = time.perf_counter()
            ys = version.integrate_adaptive(rhs, y0, times, method="dopri5")
            _sync(device)
            fwd.append(time.perf_counter() - t0)
    leaves = training.param_leaves(params)
    original = dopri.integrate_adaptive
    dopri.integrate_adaptive = version.integrate_adaptive
    try:
        step = []
        for _ in range(reps):
            for leaf in leaves:
                leaf.requires_grad_(True)
                leaf.grad = None
            _sync(device)
            t0 = time.perf_counter()
            loss = training.loss_fn(model, program, params, batch, mask, u)
            loss.backward()
            _sync(device)
            step.append(time.perf_counter() - t0)
    finally:
        dopri.integrate_adaptive = original
        for leaf in leaves:
            leaf.requires_grad_(False)
    grads = torch.cat([leaf.grad.reshape(-1) for leaf in leaves if leaf.grad is not None])
    return dict(forward_s=statistics.median(fwd), forward_all_s=fwd,
                step_s=statistics.median(step), step_all_s=step,
                attempted=len(calls) // STAGES, ys=ys, loss=loss.detach(), grads=grads)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=PATH of another checkout's ops/dopri.py (repeatable)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vihds_tpu_torch.ops import dopri
    from vihds_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    versions = {"change": dopri}
    for ref in args.ref:
        name, path = ref.split("=", 1)
        versions[name] = _load(name, path)
    refs = [r.split("=", 1)[0] for r in args.ref]
    order = refs + ["change", "change"] + refs[::-1]
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    print("card: %s" % card)
    setup = _setup(device, args.samples)
    runs, first = [], None
    for name in order:
        r = _run(versions[name], setup, device, args.reps)
        if first is None:
            first = r
        same = dict(trajectory=bool(r["ys"].shape == first["ys"].shape
                                    and bool((r["ys"] == first["ys"]).all())),
                    loss=bool((r["loss"] == first["loss"]).all()),
                    grads=bool(r["grads"].shape == first["grads"].shape
                               and bool((r["grads"] == first["grads"]).all())))
        print("%-8s forward %.4f s (%s), step %.4f s (%s), %d steps attempted; bit-equal to "
              "the first run: %s" % (name, r["forward_s"],
                                     ", ".join("%.4f" % v for v in r["forward_all_s"]),
                                     r["step_s"], ", ".join("%.4f" % v for v in r["step_all_s"]),
                                     r["attempted"], same))
        runs.append(dict(version=name, forward_s=r["forward_s"], step_s=r["step_s"],
                         forward_all_s=r["forward_all_s"], step_all_s=r["step_all_s"],
                         attempted=r["attempted"], bit_equal_to_first=same))
    print(json.dumps({"card": card, "B": int(setup[5].shape[0]), "K": int(setup[5].shape[1]),
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
