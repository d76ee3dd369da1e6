"""Hold the black-box backward kernel against other builds of it on the card.

Builds, besides this tree's ``csrc/blackbox_bwd.cu`` (through
``vihds_tpu_torch.ops.build``), a reference source tree given with ``--ref``
(for example an earlier commit's ``vihds_tpu_torch/csrc``, unpacked with
``git archive``); for each ``--rows N`` this tree's source with its block's
``BWD_ROWS`` set to N; with ``--no-dw`` this tree's source without the
pullbacks' reduction of the weight cotangent (what that costs); with
``--variant NAME=DIR`` any other source tree.  At the training shape of
``dr_blackbox_icml`` (B=36, K=200: R=7,200, T=86; chip_smoke.py phase 3's
operands) it runs every build on the same operands for each method, says
whether dW, dc and dy0 equal this tree's bit for bit (the largest
difference where not), and times each build with CUDA events (median of 20
launches) in turns: reference, this tree, the others, then the same in
reverse.  Prints the ptxas lines of the builds it makes, then one JSON line.

    python3 tools/blackbox_bwd_compare.py --ref build/parent/vihds_tpu_torch/csrc --rows 16 --no-dw

Needs an NVIDIA GPU and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "build", "compare")


def build_library(name, csrc):
    """nvcc ``csrc/blackbox_bwd.cu`` with the port's flags into
    build/compare/lib<name>.so; returns (path, ptxas lines)."""
    from vihds_tpu_torch.ops import build

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "lib%s.so" % name)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path, os.path.join(csrc, "blackbox_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc %s failed:\n%s" % (name, log))
    return path, [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "entry function" in ln]


def edited_copy(name, pattern, repl):
    """A copy of this tree's csrc under build/compare/ with ``pattern``
    replaced by ``repl`` in blackbox_common.cuh (once)."""
    from vihds_tpu_torch.ops import build

    dst = os.path.join(OUT, "csrc_" + name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    header = os.path.join(dst, "blackbox_common.cuh")
    src = open(header).read()
    new, n = re.subn(pattern, repl, src, flags=re.M)
    if n != 1:
        raise RuntimeError("%s: %d matches of %r in %s" % (name, n, pattern, header))
    open(header, "w").write(new)
    return dst


def launcher(path):
    fn = ctypes.CDLL(path).blackbox_bwd_launch
    p = ctypes.c_void_p
    fn.argtypes = [p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", help="a csrc directory holding blackbox_bwd.cu and its headers")
    ap.add_argument("--rows", type=int, action="append", default=[],
                    help="also build this tree's kernel with this many rows a block")
    ap.add_argument("--no-dw", action="store_true",
                    help="also build this tree's kernel without the weights' reduction (timing only)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="also build the csrc directory DIR (32 rows a block) as NAME")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from vihds_tpu_torch.ops import build, fused_blackbox as fb, fused_ode

    if not torch.cuda.is_available():
        print("blackbox_bwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.phase_card()
    device = torch.device("cuda")
    builds = {}  # name -> (launch function, rows a block)
    ptxas = {}
    if args.ref:
        path, ptxas["reference"] = build_library("blackbox_bwd_reference", args.ref)
        builds["reference"] = (launcher(path), 32)
    sources = [("rows%d" % rows, edited_copy("rows%d" % rows, r"^constexpr int BWD_ROWS = \d+;",
                                             "constexpr int BWD_ROWS = %d;" % rows), rows)
               for rows in args.rows]
    if args.no_dw:
        sources.append(("no_dw", edited_copy(
            "no_dw", r"for \(int it = tid / 32; it < N_DW_ITEMS;",
            "for (int it = tid / 32; it < 0;"), 32))
    sources += [tuple(v.split("=", 1)) + (32,) for v in args.variant]
    for name, csrc, rows in sources:
        path, ptxas[name] = build_library("blackbox_bwd_" + name, csrc)
        builds[name] = (launcher(path), rows)
    for name, lines in ptxas.items():
        for ln in lines:
            print("  %s ptxas: %s" % (name, ln))
    for ln in build.build(["blackbox_bwd"]).get("blackbox_bwd", "").splitlines():
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            print("  this ptxas: %s" % ln.strip())

    seed = chip_smoke.SEED + 101  # chip_smoke.py phase 3's operands at the training shape
    _, _, _, wflat, packed, y0_cols, times, shapes = chip_smoke.blackbox_inputs(
        device, chip_smoke.K_TRAIN, seed + 1)
    NS, R, T = fb.KERNEL_N_STATES, packed.shape[1], times.shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {"card": card, "R": R, "T": T, "methods": {}}
    for mi, method in enumerate(fused_ode.METHODS):
        traj = fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method)
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        g = torch.randn(traj.shape, generator=gen, device=device)
        dw, dc, dy0 = fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method)

        def run(name):
            fn, rows = builds[name]
            parts = torch.empty((-(-R // rows), fb.KERNEL_N_W), device=device)
            odc, ody0 = torch.empty_like(dc), torch.empty_like(dy0)
            err = fn(*[t.data_ptr() for t in (wflat, packed, times, traj, g, parts, odc, ody0)],
                     R, T, mi, stream)
            if err != 0:
                raise RuntimeError("%s launch failed with cudaError %d" % (name, err))
            return parts.sum(dim=0), odc, ody0

        readings = {}
        for name in builds:
            got = run(name)
            torch.cuda.synchronize()
            readings[name] = {
                "bit_equal": {k: bool(torch.equal(a, b))
                              for k, a, b in zip(("dw", "dc", "dy0"), got, (dw, dc, dy0))},
                "max_abs_diff": {k: float((a - b).abs().max())
                                 for k, a, b in zip(("dw", "dc", "dy0"), got, (dw, dc, dy0))},
            }
        names = list(builds)
        order = (["reference"] if "reference" in builds else []) + ["this"] + [
            n for n in names if n != "reference"]
        order = order + order[::-1]
        ms = {n: [] for n in order}
        for n in order:
            if n == "this":
                t = chip_smoke.cuda_ms(
                    lambda: fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method), 20)
            else:
                t = chip_smoke.cuda_ms(lambda n=n: run(n), 20)
            ms[n].append(t)
        readings["this"] = {}
        for n in ms:
            readings[n]["ms"] = ms[n]
        result["methods"][method] = readings
        print("%-9s %s" % (method, "  ".join(
            "%s %s ms%s" % (n, "/".join("%.4f" % t for t in ms[n]),
                            "" if n == "this" else " bit-equal %s" % readings[n]["bit_equal"])
            for n in ms)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
