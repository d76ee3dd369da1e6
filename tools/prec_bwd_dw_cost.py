"""What the weight cotangent costs csrc/dr_prec_bwd.cu, on an NVIDIA GPU.

    python tools/prec_bwd_dw_cost.py

The kernel keeps each thread's 80 partial sums of dW in a column of the
block's shared memory, adds into them in every right-hand side pullback, sums
them per block at the end, and leaves the sum over blocks to the wrapper.
This script builds a second copy of the kernel from the same sources with
the two accumulating statements of ``prec_rhs_vjp`` (csrc/dr_common.cuh)
removed, so that it computes everything else (dc, dy0, the block sum of the
untouched zeros), and times both on the dr_constant_precisions operands of
chip_smoke.py's phase 3 (dr_prec) at the training shape (B=36 x K=200, T=86), for the
three methods, by CUDA events in turns (kernel, copy, copy, kernel).  It
prints both ptxas reports and the time of the wrapper's sum over the
per-block partials.  The copy lives under build/ (git-ignored) and is used
for nothing else.
"""

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ACCUMULATE = (
    "      dW[(j * N_FEAT + k) * STRIDE] += dp * f[k];\n"
    "      dW[((N_PREC + j) * N_FEAT + k) * STRIDE] += dd * f[k];\n"
)


def build_without_dw(out_dir):
    """nvcc the kernel with the dW accumulation removed; returns (library
    path, ptxas log)."""
    from vihds_tpu_torch.ops import build

    src_dir = os.path.join(out_dir, "csrc")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(build.CSRC, src_dir)
    header = os.path.join(src_dir, "dr_common.cuh")
    text = open(header).read()
    if text.count(ACCUMULATE) != 1:
        raise SystemExit("prec_bwd_dw_cost: the dW accumulation of prec_rhs_vjp has changed; "
                         "update ACCUMULATE")
    with open(header, "w") as f:
        f.write(text.replace(ACCUMULATE, ""))
    lib = os.path.join(out_dir, "libdr_prec_bwd_no_dw.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(src_dir, "dr_prec_bwd.cu")],
                          capture_output=True, text=True, check=True)
    return lib, proc.stdout + proc.stderr


def main():
    import torch

    import chip_smoke
    from vihds_tpu_torch.ops import build, fused_ode
    from vihds_tpu_torch.utils import resolve_device

    if not torch.cuda.is_available():
        print("prec_bwd_dw_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    chip_smoke.phase_card()
    logs = build.build(["dr_prec_bwd"])
    lib, log = build_without_dw(os.path.join(HERE, "build", "dw_cost"))
    for name, text in (("dr_prec_bwd", logs.get("dr_prec_bwd", "")), ("without dW", log)):
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  %s ptxas: %s" % (name, ln.strip()))
    # both libraries are launched the same way, through their C entry points,
    # so that the difference is the accumulation alone: the wrapper's checks
    # and its sum over the block partials (timed on its own below) are left out
    launchers = {"kernel": fused_ode._launcher("dr_prec_bwd", 8)}
    fn = launchers["without"] = ctypes.CDLL(lib).dr_prec_bwd_launch
    fn.argtypes = launchers["kernel"].argtypes
    fn.restype = ctypes.c_int

    _, _, _, wmat, packed, y0_cols, times = chip_smoke.kind_inputs(
        device, "dr_prec", chip_smoke.K_TRAIN, chip_smoke.SEED + 8)
    R, T, S = packed.shape[1], times.shape[0], y0_cols.shape[0]
    print("dr_prec_bwd with and without its dW accumulation, B=36 x K=%d (R=%d), T=%d, "
          "median of 20 launches by CUDA events, in turns" % (chip_smoke.K_TRAIN, R, T))
    for method in fused_ode.METHODS:
        traj = fused_ode._integrate_prec_cuda(wmat, packed, y0_cols, times, method)
        g = torch.randn(traj.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(chip_smoke.SEED + 9))
        n_blocks = -(-R // fused_ode.PREC_BWD_THREADS)
        dw = torch.empty((n_blocks,) + fused_ode.WMAT_SHAPE, device=device)
        dc = torch.empty_like(packed)
        dy0 = torch.empty((S, R), device=device)
        stream = torch.cuda.current_stream(device).cuda_stream

        def launch(name):
            err = launchers[name](wmat.data_ptr(), packed.data_ptr(), times.data_ptr(),
                                  traj.data_ptr(), g.data_ptr(), dw.data_ptr(), dc.data_ptr(),
                                  dy0.data_ptr(), R, T, fused_ode.METHODS.index(method), stream)
            if err:
                raise RuntimeError("%s: launch failed with cudaError %d" % (name, err))

        ms = {"kernel": [], "without": []}
        for name in ("kernel", "without", "without", "kernel"):
            ms[name].append(chip_smoke.cuda_ms(lambda: launch(name), 20))
        partials = torch.randn((n_blocks,) + fused_ode.WMAT_SHAPE, device=device)
        sum_ms = chip_smoke.cuda_ms(lambda: partials.sum(dim=0), 20)
        print("  %-9s with dW %s ms, without %s ms: the accumulation costs %.4f ms (%.1f %%); "
              "the sum over %d block partials %.4f ms"
              % (method, ", ".join("%.4f" % t for t in ms["kernel"]),
                 ", ".join("%.4f" % t for t in ms["without"]),
                 min(ms["kernel"]) - min(ms["without"]),
                 100 * (min(ms["kernel"]) - min(ms["without"])) / min(ms["kernel"]),
                 n_blocks, sum_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
