#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vihds_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing lines of its own:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel under ``vihds_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and its time;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it (``dr_constant_icml``: B=36 series x K=1000
   samples, T=86), with its time, the plain version's time and its bound;
4. the serving path at full width: three ``predict`` requests on
   ``dr_constant_icml`` at K=1000 with ``eval_solver: pallas_midpoint``, one
   with a counterfactual, with the kernels' launch counts; then the kernel
   route held against the generic solver on a small input, and a profile
   of one request's device time;
5. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero; it also exits non-zero,
printing no result, where CUDA is not available or the package is missing.
It imports nothing of JAX and nothing of ``vihds_tpu``.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(HERE, "specs", "dr_constant_icml.yaml")
REQUESTS = ["proc141021.csv", "proc141023.csv", "proc141028.csv"]
COUNTERFACTUAL = "C6=25000;C12=0"
K_SERVE = 1000
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float32 operations of one fixed-grid step of the dr RHS per sample row,
# counted from csrc/dr_fwd.cu (an expf or a division counts as one):
# 59 per right-hand side evaluation, plus each method's state updates
DR_FLOPS_PER_STEP = {"modeuler": 2 * 59 + 42, "midpoint": 2 * 59 + 35, "rk4": 4 * 59 + 109}
# kernel vs plain PyTorch: the kernel contracts a*b+c into FMAs and the two
# evaluate expf differently, each step rounding differently from the plain
# version; over 85 steps the states then differ by float32 rounding only
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# kernel route vs the generic Python-stepped solver, through the whole
# serving forward (the weights exponentiate log-likelihoods of ~1e4 nats,
# so the per-item ELBO is compared in absolute nats)
ROUTE_RTOL, ROUTE_ATOL = 1e-3, 1e-4
ELBO_ATOL = 0.5


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` calls, timed with CUDA
    events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("phase 1: card name, power limit (nvidia-smi):")
    print(line)
    return line


def phase_build():
    from vihds_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  %s ptxas: %s" % (name, ln.strip()))
    print("phase 2: built %s in %.2f s" % (sorted(build.SOURCES), seconds))


def serving_setup(device, eval_solver="pallas_midpoint"):
    """The port's dr_constant_icml model with seeded random params."""
    import torch

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.predict import create_parser
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    args = create_parser().parse_args([SPEC, "--data", REQUESTS[0], "--seed", str(SEED)])
    settings = Config(args)
    settings.params.eval_solver = eval_solver
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(torch.Generator().manual_seed(SEED), device=device)
    return args, settings, data, program, model, params


def phase_kernels(device):
    """dr_fwd against its plain version at the serving chunk's shapes."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    _, settings, data, program, model, params = serving_setup(device)
    ds = data.train.dataset
    B = settings.params.n_batch
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times = torch.as_tensor(ds.times, dtype=torch.float32, device=device)
    inputs = torch.as_tensor(ds.inputs[:B], dtype=torch.float32, device=device)
    dev_1hot = torch.as_tensor(ds.dev_1hot[:B], dtype=torch.float32, device=device)
    with torch.no_grad():
        # theta drawn from the prior and clipped as the decoder sees it, then
        # conditioned and turned into the kernel's constants: the inputs the
        # serving path hands the kernel, in the prior's range
        u = model.sample_u(gen, B, K_SERVE, device)
        theta = program.clip(program.sample(program.prior_q(device), u))
        th = model.ode_model.condition_theta(params["dec"], program.theta_dict(theta), dev_1hot)
        consts = model.ode_model._pallas_constants(th, inputs)
        y0 = torch.broadcast_to(
            model.ode_model.initialize_state(params["dec"], th, inputs, B, K_SERVE), (B, K_SERVE, 8)
        )
        packed, y0_cols = fused_ode._pack(consts, y0)
    R, T = packed.shape[1], times.shape[0]
    print("phase 3: dr_fwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d, rtol %g atol %g"
          % (B, K_SERVE, R, T, KERNEL_RTOL, KERNEL_ATOL))
    rows = {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            got = fused_ode.dr_constant_simulate(consts, y0, times, method)
            ref = fused_ode.dr_constant_simulate_plain(consts, y0, times, method)
            torch.cuda.synchronize()
            if tuple(got.shape) != (T, B, K_SERVE, 8):
                fail("dr_fwd %s: shape %s" % (method, tuple(got.shape)))
            if not bool(torch.isfinite(ref).all()):
                fail("dr_fwd %s: the plain version is not finite on these inputs" % method)
            err = (got - ref).abs()
            max_abs = float(err.max())
            max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
            ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
            ms = cuda_ms(lambda: fused_ode._integrate_cuda(packed, y0_cols, times, method), 20)
            plain_ms = cuda_ms(
                lambda: fused_ode._integrate_plain(packed, y0_cols, times, method), 3, warmup=1
            )
            n_bytes = 4 * (packed.numel() + y0_cols.numel() + times.numel() + T * 8 * R)
            n_flops = DR_FLOPS_PER_STEP[method] * (T - 1) * R
            bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
            flops_ms = 1e3 * n_flops / FP32_FLOPS_PER_S
            rows[method] = dict(
                max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=n_bytes, flops=n_flops,
            )
            print("  %-9s max_abs_err %.3e max_rel_err %.3e  kernel %.4f ms  plain %.2f ms  "
                  "bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, max_abs, max_rel, ms, plain_ms, rows[method]["bound_ms"],
                     rows[method]["bound_by"], n_bytes, n_flops, "ok" if ok else "MISMATCH"))
            if not ok:
                fail("dr_fwd %s disagrees with its plain version" % method)
    return rows


def check_request(out, n_theta):
    m = out.merged
    B, S, T = out.host.observations.shape
    if not math.isfinite(m.elbo):
        fail("non-finite ELBO %r" % m.elbo)
    want = {
        "per_item_elbo": (B,),
        "q_mu": (B, n_theta),
        "q_prec": (B, n_theta),
        "iw_predict_mu": (B, 4, T),
        "iw_predict_std": (B, 4, T),
        "iw_states": (B, 8, T),
        "iw_variance": (B, 4, T),
    }
    import numpy as np

    for k, shape in want.items():
        if m[k].shape != shape:
            fail("%s has shape %s, want %s" % (k, m[k].shape, shape))
        if not np.isfinite(m[k]).all():
            fail("%s is not finite" % k)
    for cf in out.counterfactuals:
        for k in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance"):
            if cf[k].shape != want[k] or not np.isfinite(cf[k]).all():
                fail("counterfactual %s: %s bad (shape %s)" % (cf.spec, k, cf[k].shape))
    return B


def phase_serving(device):
    import torch

    from vihds_tpu_torch.ops import fused_ode
    from vihds_tpu_torch.predict import create_parser, predict

    _, settings, _, program, _, params = serving_setup(device)
    print("phase 4: serving dr_constant_icml, K=%d, eval_solver=%s"
          % (K_SERVE, settings.params.eval_solver))
    requests = []
    for i, f in enumerate(REQUESTS):
        argv = [SPEC, "--data", f, "--test_samples", str(K_SERVE), "--seed", str(SEED)]
        if i == 0:
            argv += ["--treatments", COUNTERFACTUAL]
        requests.append(create_parser().parse_args(argv))

    fused_ode.dr_constant_simulate.launches = 0
    walls, outs = [], []
    for args in requests:
        t0 = time.perf_counter()
        out = predict(args, settings, params=params, device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    launches = fused_ode.dr_constant_simulate.launches

    for args, out, wall in zip(requests, outs, walls):
        B = check_request(out, program.n_theta)
        print("  request %-16s %3d series  wall %.3f s  elbo %.3f%s"
              % (os.path.basename(args.data[0]), B, wall, out.merged.elbo,
                 "  + counterfactual %s" % args.treatments[0] if args.treatments else ""))
    print("  dr_fwd launches on the serving path: %d" % launches)
    if launches == 0:
        fail("the serving path never launched dr_fwd")
    return launches, walls, outs[0]


def phase_route_check(device, served):
    """The kernel route through OdeModel.simulate against the generic
    Python-stepped solver (models/dr_constant._dr_species_rhs) on a small
    input from the first request, with the same draws u."""
    import numpy as np
    import torch

    from vihds_tpu_torch.training import batch_tensors, eval_step

    host = served.host
    rows = np.arange(min(4, host.observations.shape[0]))
    results = {}
    for solver in ("pallas_midpoint", "midpoint"):
        _, _, _, program, model, params = serving_setup(device, eval_solver=solver)
        times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
        batch = batch_tensors(host, rows, times, device)
        u = torch.randn((len(rows), 50, program.n_theta),
                        generator=torch.Generator(device=device).manual_seed(SEED + 2),
                        device=device)
        with torch.no_grad():
            res = eval_step(model, program, params, batch, 50, u=u)
        results[solver] = {k: v.cpu().numpy() for k, v in res.items()}
    a, b = results["pallas_midpoint"], results["midpoint"]
    for k in ("iw_predict_mu", "iw_states"):
        np.testing.assert_allclose(a[k], b[k], rtol=ROUTE_RTOL, atol=ROUTE_ATOL, err_msg=k)
    np.testing.assert_allclose(a["per_item_elbo"], b["per_item_elbo"], rtol=0, atol=ELBO_ATOL)
    print("phase 4b: kernel route == generic midpoint solver on %d series x 50 samples "
          "(iw moments rtol %g atol %g, per-item ELBO within %g nats; max ELBO diff %.3e)"
          % (len(rows), ROUTE_RTOL, ROUTE_ATOL, ELBO_ATOL,
             float(np.abs(a["per_item_elbo"] - b["per_item_elbo"]).max())))


def phase_profile(device, wall_s):
    """Where one request's time goes: torch.profiler over the second
    request (after the counted run), device time by kernel against the
    unprofiled wall time of the same request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.predict import create_parser, load_new_data, predict
    from vihds_tpu_torch.training import Training

    _, settings, _, program, model, params = serving_setup(device)
    args = create_parser().parse_args(
        [SPEC, "--data", REQUESTS[1], "--test_samples", str(K_SERVE), "--seed", str(SEED)]
    )
    # the request's steps, timed one by one on the host clock
    t0 = time.perf_counter()
    data = build_datasets(args, settings)
    t1 = time.perf_counter()
    host = load_new_data(args.data, settings, data.train.dataset)
    t2 = time.perf_counter()
    Training(settings, data, program, model).evaluate(
        params, host, K_SERVE, torch.Generator(device=device).manual_seed(SEED), device,
        with_theta=False,
    )
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print("phase 4c: request %s steps: build_datasets %.4f s, load_new_data %.4f s, "
          "evaluate %.4f s" % (REQUESTS[1], t1 - t0, t2 - t1, t3 - t2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(args, settings, params=params, device=device)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves (device-side events); the host-side aten ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in events)
    if total_us == 0:
        print("phase 4c: profiler saw no device time (device busy share: not measured)")
        return
    print("phase 4c: request %s: %d kernel launches, device busy %.3f ms of %.3f ms "
          "unprofiled wall (busy share %.4f); top kernels by device time:"
          % (REQUESTS[1], sum(e.count for e in events), total_us / 1e3, wall_s * 1e3,
             total_us / 1e6 / wall_s))
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print("  %9.3f ms  %5d calls  %s" % (dev_us(e) / 1e3, e.count, e.key[:100]))


def main():
    if not os.path.isdir(os.path.join(HERE, "vihds_tpu_torch")):
        print("chip_smoke: the vihds_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from vihds_tpu_torch.utils import resolve_device

    device = resolve_device("cuda")
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    rows = phase_kernels(device)
    launches, walls, served = phase_serving(device)
    phase_route_check(device, served)
    phase_profile(device, walls[1])

    main_row = rows["midpoint"]  # the serving path's method
    kernels = [dict(
        name="dr_fwd",
        route="cuda",
        source="vihds_tpu_torch/csrc/dr_fwd.cu",
        replaces="vihds_tpu/ops/pallas_ode.py:340",
        method="midpoint",
        launches=launches,
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"],
        library_ms=None,  # no single PyTorch call integrates this ODE
    )]
    print("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
