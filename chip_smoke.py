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
3'. ``dr_bwd`` against its plain version at the training shape (B=36 x
   K=200, T=86) with a seeded random cotangent, all three methods, read per
   constant and state against the plain version in float64 beside the plain
   version in float32, with its time, the plain version's time and its
   bound, and ``dr_fwd`` timed at the same shape;
3''. the same for the ``dr_constant_precisions`` kernels: ``dr_prec_fwd``
   at the serving chunk (each state group against its own tolerance) and
   at the training shape, and ``dr_prec_bwd`` at the training shape, read
   per constant, state and row of the weight matrix; two ``dr_prec_bwd``
   runs must give the same weight cotangent bit for bit;
4. the serving path at full width: three ``predict`` requests on
   ``dr_constant_icml`` at K=1000 with ``eval_solver: pallas_midpoint``, one
   with a counterfactual, with the kernels' launch counts; then the kernel
   route held against the generic solver on a small input, and a profile
   of one request's device time;
5. the training path at full width: ``run_xval.run_on_split`` on
   ``dr_constant_icml`` with ``solver: pallas_midpoint`` for 4 epochs (7
   optimizer steps of B=36 x K=200 each, evaluation every 2 epochs at K=200
   on the train split and K=1000 on the valid split), the xval artifacts,
   the step times and the kernels' launch counts (``dr_bwd`` once per
   step); 5b, one step through the kernels held against the plain online
   log-likelihood route on a small input; 5c, a profile of one step;
6. serving ``dr_constant_precisions`` as phase 4 serves ``dr_constant_icml``
   (three requests at K=1000, one with a counterfactual), and one request of
   ``dr_constant_precisions_v2``, through ``dr_prec_fwd``;
7. training ``dr_constant_precisions`` as phase 5 trains ``dr_constant_icml``
   (``dr_prec_bwd`` once per step; the precision nets' weights move); 7b,
   one step through the kernels against the fold route; 7c, a profile of
   one step;
8. the ``kernels`` JSON line, then the last line
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
SPEC_PREC = os.path.join(HERE, "specs", "dr_constant_precisions.yaml")
SPEC_PREC_V2 = os.path.join(HERE, "specs", "dr_constant_precisions_v2.yaml")
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
# the same for one step of the reverse sweep, counted from csrc/dr_bwd.cu:
# 157 per right-hand side pullback (31 to recompute the forward
# intermediates, 126 to pull back), the stages' right-hand sides recomputed,
# and each method's stage and adjoint updates
DR_BWD_FLOPS_PER_STEP = {"modeuler": 447, "midpoint": 431, "rk4": 977}
# the same for the 12-state dr_prec kernels, counted from csrc/dr_common.cuh:
# a right-hand side is the species' 59 plus the precision block's 209 (9
# tanhf, 8 dot products of length 10 at 2 flop a term, 8 sigmoids at 4, 8
# for dprec); its pullback the species' 157 plus the block's 593 (the
# block's forward 201, 40 for dp, dd and dprec, 320 for the dW and df
# accumulations, 32 for the species' share).  The stage and adjoint updates
# grow with the 12 states as counted for dr: forward 2 + 5 S / 3 + 4 S /
# 5 + 13 S, backward 2 + 9 S / 2 + 7 S / 4 + 21 S (modeuler / midpoint / rk4)
PREC_S, PREC_RHS, PREC_VJP = 12, 59 + 209, 157 + 593
DR_PREC_FLOPS_PER_STEP = {
    "modeuler": 2 * PREC_RHS + 2 + 5 * PREC_S,
    "midpoint": 2 * PREC_RHS + 3 + 4 * PREC_S,
    "rk4": 4 * PREC_RHS + 5 + 13 * PREC_S,
}
DR_PREC_BWD_FLOPS_PER_STEP = {
    "modeuler": PREC_RHS + 2 * PREC_VJP + 2 + 9 * PREC_S,
    "midpoint": PREC_RHS + 2 * PREC_VJP + 2 + 7 * PREC_S,
    "rk4": 3 * PREC_RHS + 4 * PREC_VJP + 4 + 21 * PREC_S,
}
K_TRAIN = 200
# kernel vs plain PyTorch: the kernel contracts a*b+c into FMAs and the two
# evaluate expf differently, each step rounding differently from the plain
# version; over 85 steps the states then differ by float32 rounding only
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# dr_prec_fwd vs plain PyTorch, per state group.  The 8 species as above.
# The 4 precision states start near e^6 ~ 400 and span ~0.2 to ~1e4; their
# dynamics dprec = sigmoid(.) - sigmoid(.) prec contract, so the kernel's
# tanhf / expf, which differ from PyTorch's by float32 ulps, leave them within
# float32 rounding too (the TPU's approximate tanh / sigmoid moved them by
# up to 2e-2, pallas_ode.py:268-273; the card's are accurate to a few ulps).
# Their smallest values are ~0.2, so an absolute floor matters little
PREC_RTOL, PREC_ATOL = 1e-4, 1e-5
# dr_bwd vs its plain version run in float64 on the same operands (see
# cotangent_readings): each of the 23 constant rows of dc and the 8 state
# rows of dy0 is held on its own, by its largest error over its largest
# value across the R sample rows, and by the 99th percentile of its
# elements' relative errors (float32 sums over 85 steps cancel, so a few
# elements near zero may be off by more).  The plain version run in
# float32 is held to the same limits in the same run, and phase 3' prints
# its readings beside the kernel's: the limits stand well above them
BWD_NORM_TOL, BWD_P99_TOL = 1e-4, 1e-3
# kernel route vs the generic Python-stepped solver, through the whole
# serving forward (the weights exponentiate log-likelihoods of ~1e4 nats,
# so the per-item ELBO is compared in absolute nats)
ROUTE_RTOL, ROUTE_ATOL = 1e-3, 1e-4
ELBO_ATOL = 0.5
# one training step, kernel route vs the plain fold route on the card: the
# loss (~1e5 nats at random weights for dr_constant_icml, ~1e2 for
# dr_constant_precisions, whose precisions are states) sums the same float32
# terms in another order, and each gradient leaf is compared by the norm of
# its difference
LOSS_ATOL, GRAD_RTOL = 1.0, 1e-3


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


def serving_setup(device, eval_solver="pallas_midpoint", spec=SPEC):
    """The port's model of ``spec`` (dr_constant_icml unless named) with
    seeded random params."""
    import torch

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.predict import create_parser
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    args = create_parser().parse_args([spec, "--data", REQUESTS[0], "--seed", str(SEED)])
    settings = Config(args)
    settings.params.eval_solver = eval_solver
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(torch.Generator().manual_seed(SEED), device=device)
    return args, settings, data, program, model, params


def _decoder_inputs(device, K, seed, spec):
    """The kernel constants and initial states of one ``n_batch``-row chunk
    at K samples: theta drawn from the prior and clipped as the decoder sees
    it, then conditioned and turned into the kernels' constants, i.e. the
    inputs the serving and training paths hand the kernels, in the prior's
    range.  Returns (params, constants dict, y0 [B, K, S], times)."""
    import torch

    _, settings, data, program, model, params = serving_setup(device, spec=spec)
    ds = data.train.dataset
    B = settings.params.n_batch
    gen = torch.Generator(device=device).manual_seed(seed)
    times = torch.as_tensor(ds.times, dtype=torch.float32, device=device)
    inputs = torch.as_tensor(ds.inputs[:B], dtype=torch.float32, device=device)
    dev_1hot = torch.as_tensor(ds.dev_1hot[:B], dtype=torch.float32, device=device)
    ode = model.ode_model
    n_states = ode.n_species + (4 if ode.precisions.dynamic else 0)
    with torch.no_grad():
        u = model.sample_u(gen, B, K, device)
        theta = program.clip(program.sample(program.prior_q(device), u))
        th = ode.condition_theta(params["dec"], program.theta_dict(theta), dev_1hot)
        consts = ode._pallas_constants(th, inputs)
        y0 = torch.broadcast_to(
            ode.initialize_state(params["dec"], th, inputs, B, K), (B, K, n_states)
        )
    return params, consts, y0, times


def kernel_inputs(device, K, seed):
    """The dr kernels' operands of one dr_constant_icml chunk at K samples
    (``_decoder_inputs``).  Returns (constants dict, y0 [B, K, 8], packed
    [23, R], y0 [8, R], times)."""
    from vihds_tpu_torch.ops import fused_ode

    _, consts, y0, times = _decoder_inputs(device, K, seed, SPEC)
    packed, y0_cols = fused_ode._pack(consts, y0)
    return consts, y0, packed, y0_cols, times


def prec_kernel_inputs(device, K, seed):
    """The dr_prec kernels' operands of one dr_constant_precisions chunk at K
    samples, with the model's seeded random precision nets.  Returns
    (constants dict, precision params, y0 [B, K, 12], wmat [8, 10], packed
    [23, R], y0 [12, R], times)."""
    from vihds_tpu_torch.ops import fused_ode

    params, consts, y0, times = _decoder_inputs(device, K, seed, SPEC_PREC)
    prec_params = params["dec"]["precisions"]
    packed, y0_cols = fused_ode._pack(consts, y0, y0.shape[-1])
    return consts, prec_params, y0, fused_ode._prec_wmat(prec_params), packed, y0_cols, times


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 peak."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * n_flops / FP32_FLOPS_PER_S
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def fwd_row(packed, y0_cols, times, method):
    """dr_fwd's kernel time, plain time and bound on these operands."""
    from vihds_tpu_torch.ops import fused_ode

    R, T = packed.shape[1], times.shape[0]
    ms = cuda_ms(lambda: fused_ode._integrate_cuda(packed, y0_cols, times, method), 20)
    plain_ms = cuda_ms(
        lambda: fused_ode._integrate_plain(packed, y0_cols, times, method), 3, warmup=1
    )
    n_bytes = 4 * (packed.numel() + y0_cols.numel() + times.numel() + T * 8 * R)
    n_flops = DR_FLOPS_PER_STEP[method] * (T - 1) * R
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, flops=n_flops)


def phase_kernels(device):
    """dr_fwd against its plain version at the serving chunk's shapes."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    consts, y0, packed, y0_cols, times = kernel_inputs(device, K_SERVE, SEED + 1)
    B = y0.shape[0]
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
            rows[method] = dict(max_abs_err=max_abs, max_rel_err=max_rel,
                                **fwd_row(packed, y0_cols, times, method))
            r = rows[method]
            print("  %-9s max_abs_err %.3e max_rel_err %.3e  kernel %.4f ms  plain %.2f ms  "
                  "bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, max_abs, max_rel, r["ms"], r["plain_ms"], r["bound_ms"],
                     r["bound_by"], r["bytes"], r["flops"], "ok" if ok else "MISMATCH"))
            if not ok:
                fail("dr_fwd %s disagrees with its plain version" % method)
    return rows


def cotangent_readings(got, ref):
    """Per row of a backward output [n, R] against its float64 reference
    ``ref``: (normwise error, the largest |got - ref| over the largest
    |ref|; the 99th percentile of |got - ref| / |ref|), two float64 [n]
    tensors.  Each constant (and state) is read on its own: one sample row
    of dc spans many decades across the constants, and one constant's
    cotangent many decades across the samples."""
    err = (got.double() - ref).abs()
    norm = err.amax(dim=1) / ref.abs().amax(dim=1).clamp_min(1e-300)
    rel = (err / ref.abs().clamp_min(1e-300)).quantile(0.99, dim=1)
    return norm, rel


def cotangents_ok(got, ref):
    """True when ``got`` is finite and every row is within BWD_NORM_TOL
    (normwise) and BWD_P99_TOL (99th percentile relative) of ``ref``."""
    import torch

    norm, rel = cotangent_readings(got, ref)
    return (bool(torch.isfinite(got).all()) and bool((norm <= BWD_NORM_TOL).all())
            and bool((rel <= BWD_P99_TOL).all()))


def phase_bwd(device):
    """Phase 3': dr_bwd against its plain version at the training shape
    (B=36 series x K=200 samples, T=86), all three methods, with a seeded
    random trajectory cotangent.  Both the kernel and the plain version in
    float32 are read against the plain version in float64 on the same
    operands, per constant; dr_fwd timed at the same shape."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    _, y0, packed, y0_cols, times = kernel_inputs(device, K_TRAIN, SEED + 3)
    B = y0.shape[0]
    R, T = packed.shape[1], times.shape[0]
    row_names = list(fused_ode.DR_CONST_NAMES) + ["y0[%d]" % s for s in range(8)]
    print("phase 3': dr_bwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d, both read against the "
          "plain version in float64; every constant's and state's row within %g normwise and "
          "%g at the 99th percentile of relative error"
          % (B, K_TRAIN, R, T, BWD_NORM_TOL, BWD_P99_TOL))
    rows, fwd_rows, readings = {}, {}, {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            traj = fused_ode._integrate_cuda(packed, y0_cols, times, method)
            gen = torch.Generator(device=device).manual_seed(SEED + 4)
            g = torch.randn(traj.shape, generator=gen, device=device)
            got = torch.cat(fused_ode.dr_bwd(packed, times, traj, g, method))
            plain = torch.cat(fused_ode._integrate_plain_bwd(packed, times, traj, g, method))
            ref = torch.cat(fused_ode._integrate_plain_bwd(
                packed.double(), times.double(), traj.double(), g.double(), method))
            torch.cuda.synchronize()
            if not bool(torch.isfinite(ref).all()):
                fail("dr_bwd %s: the plain version is not finite on these inputs" % method)
            k_norm, k_rel = cotangent_readings(got, ref)
            p_norm, p_rel = cotangent_readings(plain, ref)
            readings[method] = (k_norm, k_rel, p_norm, p_rel)
            err = (got.double() - ref).abs()
            ms = cuda_ms(lambda: fused_ode.dr_bwd(packed, times, traj, g, method), 20)
            plain_ms = cuda_ms(
                lambda: fused_ode._integrate_plain_bwd(packed, times, traj, g, method), 3, warmup=1
            )
            n_bytes = 4 * (2 * packed.numel() + times.numel() + 2 * T * 8 * R + 8 * R)
            n_flops = DR_BWD_FLOPS_PER_STEP[method] * (T - 1) * R
            bound_ms, bound_by = bound(n_bytes, n_flops)
            rows[method] = dict(
                max_abs_err=float(err.max()),
                max_rel_err=float((err / ref.abs().clamp_min(1e-300)).max()),
                worst_norm=float(k_norm.max()), worst_p99=float(k_rel.max()),
                plain_worst_norm=float(p_norm.max()), plain_worst_p99=float(p_rel.max()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, flops=n_flops,
            )
            fwd_rows[method] = fwd_row(packed, y0_cols, times, method)
            r, f = rows[method], fwd_rows[method]
            ok = cotangents_ok(got, ref)
            print("  %-9s kernel: worst normwise %.3e (%s), worst p99 rel %.3e (%s); plain "
                  "float32: %.3e, %.3e | max_abs_err %.3e on |ref| up to %.3e, max_rel_err %.3e  "
                  "kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, r["worst_norm"], row_names[int(k_norm.argmax())], r["worst_p99"],
                     row_names[int(k_rel.argmax())], r["plain_worst_norm"],
                     r["plain_worst_p99"], r["max_abs_err"], float(ref.abs().max()),
                     r["max_rel_err"], ms, plain_ms, bound_ms, bound_by, n_bytes, n_flops,
                     "ok" if ok else "MISMATCH"))
            print("  %-9s dr_fwd at this shape: kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s)"
                  % (method, f["ms"], f["plain_ms"], f["bound_ms"], f["bound_by"]))
            if not ok:
                fail("dr_bwd %s disagrees with its plain version" % method)
            if not cotangents_ok(plain, ref):
                fail("dr_bwd %s: the plain version in float32 is outside the tolerance itself"
                     % method)
    print("  per row, normwise error / 99th percentile relative error against float64, "
          "kernel then plain float32, for %s:" % ", ".join(fused_ode.METHODS))
    for i, name in enumerate(row_names):
        print("    %-9s" % name + "  |".join(
            " %.1e %.1e / %.1e %.1e" % tuple(float(x[i]) for x in readings[m])
            for m in fused_ode.METHODS))
    return rows, fwd_rows


def prec_fwd_row(wmat, packed, y0_cols, times, method):
    """dr_prec_fwd's kernel time, plain time and bound on these operands."""
    from vihds_tpu_torch.ops import fused_ode

    R, T, S = packed.shape[1], times.shape[0], y0_cols.shape[0]
    ms = cuda_ms(lambda: fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, method), 20)
    plain_ms = cuda_ms(
        lambda: fused_ode._integrate_prec_plain(wmat, packed, y0_cols, times, method), 3, warmup=1
    )
    n_bytes = 4 * (wmat.numel() + packed.numel() + y0_cols.numel() + times.numel() + T * S * R)
    n_flops = DR_PREC_FLOPS_PER_STEP[method] * (T - 1) * R
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, flops=n_flops)


def prec_states_ok(got, ref):
    """dr_prec_fwd's trajectory [T, B, K, 12] against the plain version's,
    each state group to its own tolerance: (species max relative error,
    precisions max relative error, ok)."""
    import torch

    out = []
    ok = bool(torch.isfinite(got).all())
    for sl, rtol, atol in ((slice(0, 8), KERNEL_RTOL, KERNEL_ATOL),
                           (slice(8, 12), PREC_RTOL, PREC_ATOL)):
        a, b = got[..., sl], ref[..., sl]
        err = (a - b).abs()
        out.append(float((err / b.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((err <= atol + rtol * b.abs()).all())
    return out[0], out[1], ok


def phase_prec_kernels(device):
    """Phase 3'': the dr_constant_precisions kernels against their plain
    versions, all three methods: dr_prec_fwd at the serving chunk (B=36,
    K=1000) and at the training shape (B=36, K=200), dr_prec_bwd at the
    training shape with a seeded random cotangent, read as phase 3' reads
    dr_bwd, plus the 8 rows of the weight cotangent over their 10 columns."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    consts, prec_params, y0, wmat, packed, y0_cols, times = prec_kernel_inputs(
        device, K_SERVE, SEED + 7)
    B = y0.shape[0]
    R, T = packed.shape[1], times.shape[0]
    print("phase 3'': dr_prec_fwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d; species rtol %g "
          "atol %g, precisions rtol %g atol %g" % (B, K_SERVE, R, T, KERNEL_RTOL, KERNEL_ATOL,
                                                  PREC_RTOL, PREC_ATOL))
    fwd_rows = {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            got = fused_ode.dr_constant_precisions_simulate(consts, prec_params, y0, times, method)
            ref = fused_ode.dr_constant_precisions_simulate_plain(consts, prec_params, y0, times,
                                                                  method)
            torch.cuda.synchronize()
            if tuple(got.shape) != (T, B, K_SERVE, 12):
                fail("dr_prec_fwd %s: shape %s" % (method, tuple(got.shape)))
            if not bool(torch.isfinite(ref).all()):
                fail("dr_prec_fwd %s: the plain version is not finite on these inputs" % method)
            rel_x, rel_p, ok = prec_states_ok(got, ref)
            r = fwd_rows[method] = dict(max_abs_err=float((got - ref).abs().max()),
                                        max_rel_species=rel_x, max_rel_precisions=rel_p,
                                        **prec_fwd_row(wmat, packed, y0_cols, times, method))
            print("  %-9s max_rel_err species %.3e precisions %.3e (max_abs_err %.3e on |ref| up "
                  "to %.3e)  kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, rel_x, rel_p, r["max_abs_err"], float(ref.abs().max()), r["ms"],
                     r["plain_ms"], r["bound_ms"], r["bound_by"], r["bytes"], r["flops"],
                     "ok" if ok else "MISMATCH"))
            if not ok:
                fail("dr_prec_fwd %s disagrees with its plain version" % method)

    _, _, y0, wmat, packed, y0_cols, times = prec_kernel_inputs(device, K_TRAIN, SEED + 8)
    R = packed.shape[1]
    S = y0_cols.shape[0]
    row_names = (list(fused_ode.DR_CONST_NAMES) + ["y0[%d]" % s for s in range(S)]
                 + ["W[%d,:]" % j for j in range(fused_ode.WMAT_SHAPE[0])])
    print("phase 3'': dr_prec_bwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d, both read against "
          "the plain version in float64: every constant's and state's row over the samples, "
          "and every row of the weight cotangent over its 10 columns, within %g normwise and %g "
          "at the 99th percentile of relative error"
          % (B, K_TRAIN, R, T, BWD_NORM_TOL, BWD_P99_TOL))
    rows, train_fwd_rows, readings = {}, {}, {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            traj = fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, method)
            gen = torch.Generator(device=device).manual_seed(SEED + 9)
            g = torch.randn(traj.shape, generator=gen, device=device)
            dw, dc, dy0 = fused_ode.dr_prec_bwd(wmat, packed, times, traj, g, method)
            dw_again = fused_ode.dr_prec_bwd(wmat, packed, times, traj, g, method)[0]
            pw, pc, py = fused_ode._integrate_prec_plain_bwd(wmat, packed, times, traj, g, method)
            rw, rc, ry = fused_ode._integrate_prec_plain_bwd(
                wmat.double(), packed.double(), times.double(), traj.double(), g.double(), method)
            torch.cuda.synchronize()
            ref = torch.cat([rc, ry])
            if not (bool(torch.isfinite(ref).all()) and bool(torch.isfinite(rw).all())):
                fail("dr_prec_bwd %s: the plain version is not finite on these inputs" % method)
            k_norm, k_rel = (torch.cat(x) for x in zip(
                cotangent_readings(torch.cat([dc, dy0]), ref), cotangent_readings(dw, rw)))
            p_norm, p_rel = (torch.cat(x) for x in zip(
                cotangent_readings(torch.cat([pc, py]), ref), cotangent_readings(pw, rw)))
            readings[method] = (k_norm, k_rel, p_norm, p_rel)
            ok = (cotangents_ok(torch.cat([dc, dy0]), ref) and cotangents_ok(dw, rw))
            plain_ok = (cotangents_ok(torch.cat([pc, py]), ref) and cotangents_ok(pw, rw))
            same = bool(torch.equal(dw, dw_again))
            err = (torch.cat([dc, dy0]).double() - ref).abs()
            ms = cuda_ms(lambda: fused_ode.dr_prec_bwd(wmat, packed, times, traj, g, method), 20)
            plain_ms = cuda_ms(lambda: fused_ode._integrate_prec_plain_bwd(
                wmat, packed, times, traj, g, method), 3, warmup=1)
            # inputs read once (weights, constants, grid, traj, g), outputs
            # written once (dW, dc, dy0)
            n_bytes = 4 * (2 * wmat.numel() + 2 * packed.numel() + times.numel()
                           + 2 * T * S * R + S * R)
            n_flops = DR_PREC_BWD_FLOPS_PER_STEP[method] * (T - 1) * R
            bound_ms, bound_by = bound(n_bytes, n_flops)
            r = rows[method] = dict(
                max_abs_err=float(err.max()),
                max_rel_err=float((err / ref.abs().clamp_min(1e-300)).max()),
                dw_max_rel_err=float(((dw.double() - rw).abs() / rw.abs().clamp_min(1e-300)).max()),
                worst_norm=float(k_norm.max()), worst_p99=float(k_rel.max()),
                plain_worst_norm=float(p_norm.max()), plain_worst_p99=float(p_rel.max()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, flops=n_flops,
            )
            f = train_fwd_rows[method] = prec_fwd_row(wmat, packed, y0_cols, times, method)
            print("  %-9s kernel: worst normwise %.3e (%s), worst p99 rel %.3e (%s); plain "
                  "float32: %.3e, %.3e | dW max rel err %.3e, repeat run bit-equal: %s  kernel "
                  "%.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, r["worst_norm"], row_names[int(k_norm.argmax())], r["worst_p99"],
                     row_names[int(k_rel.argmax())], r["plain_worst_norm"],
                     r["plain_worst_p99"], r["dw_max_rel_err"], same, ms, plain_ms, bound_ms,
                     bound_by, n_bytes, n_flops, "ok" if ok else "MISMATCH"))
            print("  %-9s dr_prec_fwd at this shape: kernel %.4f ms  plain %.2f ms  bound %.4f ms "
                  "(%s)" % (method, f["ms"], f["plain_ms"], f["bound_ms"], f["bound_by"]))
            if not ok:
                fail("dr_prec_bwd %s disagrees with its plain version" % method)
            if not plain_ok:
                fail("dr_prec_bwd %s: the plain version in float32 is outside the tolerance "
                     "itself" % method)
            if not same:
                fail("dr_prec_bwd %s: two runs gave different weight cotangents" % method)
    print("  per row, normwise error / 99th percentile relative error against float64, "
          "kernel then plain float32, for %s:" % ", ".join(fused_ode.METHODS))
    for i, name in enumerate(row_names):
        print("    %-9s" % name + "  |".join(
            " %.1e %.1e / %.1e %.1e" % tuple(float(x[i]) for x in readings[m])
            for m in fused_ode.METHODS))
    return fwd_rows, rows, train_fwd_rows


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


def _counter(kernel):
    """The function whose ``launches`` attribute counts ``kernel``'s launches."""
    from vihds_tpu_torch.ops import fused_ode

    return {"dr_fwd": fused_ode.dr_constant_simulate, "dr_bwd": fused_ode.dr_bwd,
            "dr_prec_fwd": fused_ode.dr_constant_precisions_simulate,
            "dr_prec_bwd": fused_ode.dr_prec_bwd}[kernel]


def serve(device, spec, files, phase, kernel):
    """``predict`` one request per CSV of ``files`` on ``spec``'s model at
    K=1000 through the kernels (``eval_solver: pallas_midpoint``), the first
    with a counterfactual.  Counts ``kernel``'s launches from 0; returns
    (launches, request walls, the first request's output)."""
    import torch

    from vihds_tpu_torch.predict import create_parser, predict

    _, settings, _, program, _, params = serving_setup(device, spec=spec)
    name = os.path.basename(spec)[: -len(".yaml")]
    print("phase %s: serving %s, K=%d, eval_solver=%s"
          % (phase, name, K_SERVE, settings.params.eval_solver))
    requests = []
    for i, f in enumerate(files):
        argv = [spec, "--data", f, "--test_samples", str(K_SERVE), "--seed", str(SEED)]
        if i == 0:
            argv += ["--treatments", COUNTERFACTUAL]
        requests.append(create_parser().parse_args(argv))

    _counter(kernel).launches = 0
    walls, outs = [], []
    for args in requests:
        t0 = time.perf_counter()
        out = predict(args, settings, params=params, device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    launches = _counter(kernel).launches

    for args, out, wall in zip(requests, outs, walls):
        B = check_request(out, program.n_theta)
        print("  request %-16s %3d series  wall %.3f s  elbo %.3f%s"
              % (os.path.basename(args.data[0]), B, wall, out.merged.elbo,
                 "  + counterfactual %s" % args.treatments[0] if args.treatments else ""))
    print("  %s launches on the serving path of %s: %d" % (kernel, name, launches))
    if launches == 0:
        fail("the serving path of %s never launched %s" % (name, kernel))
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
    events, total_us = device_events(prof)
    if total_us == 0:
        print("phase 4c: profiler saw no device time (device busy share: not measured)")
        return
    print("phase 4c: request %s: %d kernel launches, device busy %.3f ms of %.3f ms "
          "unprofiled wall (busy share %.4f); top kernels by device time:"
          % (REQUESTS[1], sum(e.count for e in events), total_us / 1e3, wall_s * 1e3,
             total_us / 1e6 / wall_s))
    for e in events[:8]:
        print("  %9.3f ms  %5d calls  %s" % (dev_us(e) / 1e3, e.count, e.key[:100]))


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(prof):
    """The kernels a profile saw (device-side events, the host-side aten ops
    that launched them carry the same time again), longest first, and
    their summed device microseconds."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    return events, sum(dev_us(e) for e in events)


TRAIN_FLAGS = ["--experiment", "chip_smoke", "--epochs", "4", "--test_epoch", "2",
               "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed", str(SEED)]
TRAIN_SOLVER = "pallas_midpoint"


def training_settings(solver=TRAIN_SOLVER, spec=SPEC):
    """run_xval's args and settings for ``spec`` (dr_constant_icml unless
    named), with ``solver`` set as phase 4 sets ``eval_solver``."""
    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Config

    args = run_xval.create_parser(True).parse_args([spec] + TRAIN_FLAGS)
    settings = Config(args)
    settings.params.solver = solver
    return args, settings


def train(device, spec, phase, fwd, bwd):
    """Train ``spec``'s model through run_on_split (4 epochs, eval every 2,
    K=200 / K=1000), write the xval artifacts as run_xval.main does, and
    count the launches of the kernels ``fwd`` and ``bwd`` from 0."""
    import statistics
    import tempfile

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Trainer

    args, settings = training_settings(spec=spec)
    name = os.path.basename(spec)[: -len(".yaml")]
    with tempfile.TemporaryDirectory() as results_dir:
        os.environ["INFERENCE_RESULTS_DIR"] = results_dir
        settings.trainer = Trainer(args, add_timestamp=True)
        print("phase %s: training %s, split 1 of 4, solver %s, B=%d, K=%d, T=86, "
              "epochs %d, eval every %d at K=%d (train split) / %d (valid split)"
              % (phase, name, settings.params.solver, settings.params.n_batch, args.train_samples,
                 args.epochs, args.test_epoch, args.train_samples, args.test_samples))
        _counter(fwd).launches = 0
        _counter(bwd).launches = 0
        t0 = time.perf_counter()
        data, results, training = run_xval.run_on_split(args, settings, device=device)
        wall = time.perf_counter() - t0
        launches = {fwd: _counter(fwd).launches, bwd: _counter(bwd).launches}
        if results is None:
            fail("training left no best-validation results")
        run_xval.save_xval(args, settings, data, results)
        names = set(os.listdir(settings.trainer.tb_log_dir))
        cache = training.cache_dir
        n_xval = len([n for n in names if n.startswith("xval_")])
        if not os.path.isdir(cache) or n_xval != 16 or "completed.txt" not in names:
            fail("training artifacts missing: %s" % sorted(names))
    del os.environ["INFERENCE_RESULTS_DIR"]

    log = training.log_data
    elbos = log.training_elbo_list + log.validation_elbo_list + list(results.elbo_list)
    if not elbos or not all(math.isfinite(e) for e in elbos):
        fail("non-finite ELBOs %s" % elbos)
    steps = len(training.step_ms)
    spe = training.steps_per_epoch
    step_ms = statistics.median(training.step_ms[spe:])
    print("  %d optimizer steps (%d per epoch) in %.2f s wall; median step %.2f ms after the "
          "first epoch (first epoch's steps: %s ms)"
          % (steps, spe, wall, step_ms, ", ".join("%.1f" % t for t in training.step_ms[:spe])))
    print("  best-val cache %s and %d xval_* files written" % (os.path.basename(cache), n_xval))
    print("  %s launches %d, %s launches %d (optimizer steps %d)"
          % (fwd, launches[fwd], bwd, launches[bwd], steps))
    if steps != args.epochs * spe or launches[bwd] != steps:
        fail("%s launched %d times for %d optimizer steps" % (bwd, launches[bwd], steps))
    if launches[fwd] <= steps:
        fail("%s launched %d times: the evaluations did not take the kernel"
             % (fwd, launches[fwd]))
    return launches, step_ms, training


def phase_training_precisions(device):
    """Phase 7: train dr_constant_precisions as phase 5 trains
    dr_constant_icml; the weight cotangent of dr_prec_bwd must move every
    leaf of the precision nets away from its seeded initial value."""
    import torch

    launches, step_ms, training = train(device, SPEC_PREC, "7", "dr_prec_fwd", "dr_prec_bwd")
    init = training.model.init_params(torch.Generator().manual_seed(SEED), device=device)
    moved = []
    for net in ("prod", "degr"):
        for leaf in ("w", "b"):
            a = training.final_params["dec"]["precisions"][net][leaf].detach()
            b = init["dec"]["precisions"][net][leaf]
            if not bool(torch.isfinite(a).all()):
                fail("precisions/%s/%s is not finite after training" % (net, leaf))
            moved.append(("%s.%s" % (net, leaf), float((a - b).abs().max())))
    print("  precision nets' leaves moved by (max abs change): %s"
          % ", ".join("%s %.3e" % m for m in moved))
    if not all(d > 0 for _, d in moved):
        fail("a precision net's leaf did not move: the weight cotangent did not reach it")
    return launches, step_ms, training


def one_step(device, solver, rows, K, seed, spec=SPEC):
    """(Training, params, optimizer, step closure) for one training step of
    ``spec``'s model (dr_constant_icml unless named) under ``solver`` on the
    train split's ``rows`` at K draws, with seeded params and draws ``u``,
    set up as run_on_split sets it up."""
    import numpy as np
    import torch

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.training import batch_tensors, loss_fn

    args, settings = training_settings(solver, spec)
    data, training = run_xval.make_training(args, settings, device=device)
    params, opt, _ = training.init_state(device)
    host = data.train.batch()
    batch = batch_tensors(host, np.asarray(rows), torch.as_tensor(
        host.times, dtype=torch.float32, device=device), device)
    u = torch.randn((len(rows), K, training.program.n_theta), device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    mask = torch.ones(len(rows), device=device)

    def step():
        opt.zero_grad()
        loss = loss_fn(training.model, training.program, params, batch, mask, u)
        loss.backward()
        return loss

    return training, params, opt, step


def phase_route_check_training(device, spec=SPEC, phase="5b"):
    """Phase 5b (7b for dr_constant_precisions): one loss and gradient on 4
    series x 50 samples, with the same params and u, through the kernels
    (pallas_midpoint) and through the plain online log-likelihood route
    (midpoint) on the card."""
    import torch

    from vihds_tpu_torch.training import param_leaves

    out = {}
    for solver in (TRAIN_SOLVER, "midpoint"):
        _, params, _, step = one_step(device, solver, range(4), 50, SEED + 5, spec)
        loss = step()
        torch.cuda.synchronize()
        grads = [leaf.grad.detach().clone() for leaf in param_leaves(params)]
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[solver] = (float(loss.detach()), grads, sorted(walls)[1])
    (lk, gk, wk), (lf, gf, wf) = out[TRAIN_SOLVER], out["midpoint"]
    rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(gk, gf))
    print("phase %s: one training step of %s, 4 series x 50 samples: loss %s %.4f vs midpoint "
          "fold route %.4f (diff %.3e nats, tol %g); gradients max leaf relative norm diff %.3e "
          "(tol %g); step wall %.4f s (kernels) vs %.4f s (fold route, plain PyTorch)"
          % (phase, os.path.basename(spec)[: -len(".yaml")], TRAIN_SOLVER, lk, lf, abs(lk - lf),
             LOSS_ATOL, rel, GRAD_RTOL, wk, wf))
    if not (abs(lk - lf) <= LOSS_ATOL and rel <= GRAD_RTOL):
        fail("the kernel route's training step disagrees with the fold route")
    return wk, wf


def phase_profile_training(device, spec=SPEC, phase="5c", kernels=("dr_fwd", "dr_bwd")):
    """Phase 5c (7c for dr_constant_precisions): torch.profiler over one
    full-size training step (B=36, K=200) after a warm-up step: device busy
    share of the step's wall and where the model's two kernels stand among
    the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    training, _, _, step = one_step(device, TRAIN_SOLVER, range(36), K_TRAIN, SEED + 6, spec)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events, total_us = device_events(prof)
    if total_us == 0:
        print("phase %s: profiler saw no device time (device busy share: not measured)" % phase)
        return None
    print("phase %s: one training step of %s (B=36, K=%d, %s): %d kernel launches, device busy "
          "%.3f ms of %.3f ms unprofiled step wall (busy share %.4f; profiled wall %.3f ms); "
          "top kernels by device time:"
          % (phase, os.path.basename(spec)[: -len(".yaml")], K_TRAIN, TRAIN_SOLVER,
             sum(e.count for e in events), total_us / 1e3, wall * 1e3, total_us / 1e6 / wall,
             prof_wall * 1e3))
    for i, e in enumerate(events):
        if i < 10 or any(k + "_kernel" in e.key for k in kernels):
            print("  #%-3d %9.3f ms  %5d calls  %s" % (i + 1, dev_us(e) / 1e3, e.count, e.key[:100]))
    return dict(busy_ms=total_us / 1e3, wall_ms=wall * 1e3)


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
    bwd_rows, fwd_train_rows = phase_bwd(device)
    prec_rows, prec_bwd_rows, prec_fwd_train_rows = phase_prec_kernels(device)
    launches, walls, served = serve(device, SPEC, REQUESTS, "4", "dr_fwd")
    phase_route_check(device, served)
    phase_profile(device, walls[1])
    train_launches, _, _ = train(device, SPEC, "5", "dr_fwd", "dr_bwd")
    phase_route_check_training(device)
    phase_profile_training(device)
    prec_launches, _, _ = serve(device, SPEC_PREC, REQUESTS, "6", "dr_prec_fwd")
    # v2's version lives in the host-side fracLuxR / fracLasR: the same kernel
    serve(device, SPEC_PREC_V2, REQUESTS[:1], "6", "dr_prec_fwd")
    prec_train_launches, _, _ = phase_training_precisions(device)
    phase_route_check_training(device, SPEC_PREC, "7b")
    phase_profile_training(device, SPEC_PREC, "7c", ("dr_prec_fwd", "dr_prec_bwd"))

    fwd, fwd_train, bwd = rows["midpoint"], fwd_train_rows["midpoint"], bwd_rows["midpoint"]
    kernels = [
        dict(
            name="dr_fwd",
            route="cuda",
            source="vihds_tpu_torch/csrc/dr_fwd.cu",
            replaces="vihds_tpu/ops/pallas_ode.py:340",
            method="midpoint",
            # the training path's count; the serving path's beside it
            launches=train_launches["dr_fwd"],
            launches_serving=launches,
            # at the serving chunk (B=36, K=1000); the training shape beside it
            max_abs_err=fwd["max_abs_err"],
            ms=fwd["ms"],
            plain_ms=fwd["plain_ms"],
            bound_ms=fwd["bound_ms"],
            bound_by=fwd["bound_by"],
            train_shape={k: fwd_train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            library_ms=None,  # no single PyTorch call integrates this ODE
        ),
        dict(
            name="dr_bwd",
            route="cuda",
            source="vihds_tpu_torch/csrc/dr_bwd.cu",
            replaces="vihds_tpu/ops/pallas_ode.py:364",
            method="midpoint",
            launches=train_launches["dr_bwd"],
            max_abs_err=bwd["max_abs_err"],
            ms=bwd["ms"],
            plain_ms=bwd["plain_ms"],
            bound_ms=bwd["bound_ms"],
            bound_by=bwd["bound_by"],
            library_ms=None,  # no single PyTorch call computes this ODE's VJP
        ),
        dict(
            name="dr_prec_fwd",
            route="cuda",
            source="vihds_tpu_torch/csrc/dr_prec_fwd.cu",
            replaces="vihds_tpu/ops/pallas_ode.py:473",
            method="midpoint",
            # the training path's count; the serving path's beside it
            launches=prec_train_launches["dr_prec_fwd"],
            launches_serving=prec_launches,
            # at the serving chunk (B=36, K=1000); the training shape beside it
            max_abs_err=prec_rows["midpoint"]["max_abs_err"],
            ms=prec_rows["midpoint"]["ms"],
            plain_ms=prec_rows["midpoint"]["plain_ms"],
            bound_ms=prec_rows["midpoint"]["bound_ms"],
            bound_by=prec_rows["midpoint"]["bound_by"],
            train_shape={k: prec_fwd_train_rows["midpoint"][k]
                         for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            library_ms=None,  # no single PyTorch call integrates this ODE
        ),
        dict(
            name="dr_prec_bwd",
            route="cuda",
            source="vihds_tpu_torch/csrc/dr_prec_bwd.cu",
            replaces="vihds_tpu/ops/pallas_ode.py:500",
            method="midpoint",
            launches=prec_train_launches["dr_prec_bwd"],
            max_abs_err=prec_bwd_rows["midpoint"]["max_abs_err"],
            ms=prec_bwd_rows["midpoint"]["ms"],
            plain_ms=prec_bwd_rows["midpoint"]["plain_ms"],
            bound_ms=prec_bwd_rows["midpoint"]["bound_ms"],
            bound_by=prec_bwd_rows["midpoint"]["bound_by"],
            library_ms=None,  # no single PyTorch call computes this ODE's VJP
        ),
    ]
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
