"""Hold a black-box kernel, the backward or the forward, against other builds
of it on the card.

Builds, besides this tree's ``csrc/blackbox_bwd.cu`` (``--direction bwd``,
the default) or ``csrc/blackbox_fwd.cu`` (``--direction fwd``), both through
``vihds_tpu_torch.ops.build``, a reference source tree given with ``--ref``
(for example an earlier commit's ``vihds_tpu_torch/csrc``, unpacked with
``git archive``); for each ``--rows N`` this tree's source with its block's
``BWD_ROWS`` (which the forward's ``FWD_ROWS`` follows) set to N; with
``--no-dw`` this tree's backward without the pullbacks' reduction of the
weight cotangent (what that costs); with ``--rowwise`` the forward's variant
``tools/blackbox_fwd_rowwise.cu`` (one thread per row, 32-row blocks, no
barriers); with ``--variant NAME=DIR`` any other source tree.  The backward
runs at the training shape of ``dr_blackbox_icml`` (B=36, K=200: R=7,200,
T=86), the forward there and at the serving chunk (K=1000: R=36,000), on
chip_smoke.py phase 3's operands.  This tree's source is built a second
time as the others are, and every build is run and timed through its bare C
entry point.  For each shape and method it runs every build on the same
operands, says whether its outputs (dW, dc and dy0; the trajectory) equal
those of this tree's wrapper (``fused_blackbox``) bit for bit (the largest
difference, and for the trajectory the most ulps, where not), and times
each build with CUDA events (median of 20 launches) in turns: reference,
this tree, the others, then the same in reverse.  Prints the ptxas lines of
the builds and whether each build's SASS equals this tree's (where the
toolkit has cuobjdump), then one JSON line.

    python3 tools/blackbox_bwd_compare.py --ref build/parent/vihds_tpu_torch/csrc --rows 16 --no-dw
    python3 tools/blackbox_bwd_compare.py --direction fwd --ref build/parent/vihds_tpu_torch/csrc --rowwise

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
ROWWISE = os.path.join(HERE, "tools", "blackbox_fwd_rowwise.cu")


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_library(name, source, include=None):
    """nvcc ``source`` with the port's flags (and ``-I include``) into
    build/compare/lib<name>.so; returns (path, ptxas lines)."""
    from vihds_tpu_torch.ops import build

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "lib%s.so" % name)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *(["-I", include] if include else []), "-o",
           path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc %s failed:\n%s" % (name, log))
    return path, ptxas_lines(log)


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


def launcher(path, direction, source):
    """The C entry point of a build of ``blackbox_<direction>.cu`` from
    ``source``, called with the arguments of one without the fold count."""
    from prec_bwd_compare import single_fold, takes_folds

    entry = "blackbox_%s_launch" % direction
    folds = takes_folds(source, entry)
    fn = getattr(ctypes.CDLL(path), entry)
    p = ctypes.c_void_p
    fn.argtypes = ([p] * {"fwd": 5, "bwd": 8}[direction] + [ctypes.c_int] * (4 if folds else 3)
                   + [p])
    fn.restype = ctypes.c_int
    return single_fold(fn, folds)


def sass(path):
    """The instructions of the kernels in a library as cuobjdump prints them,
    without addresses, encodings and names (a sorted list, a tuple a
    kernel), or None where the toolkit has no cuobjdump."""
    from vihds_tpu_torch.ops import build

    exe = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    dump = subprocess.run([exe, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    kernels = []
    for ln in dump.splitlines():
        if "Function :" in ln:
            kernels.append([])
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;", ln)
        if m and kernels:
            kernels[-1].append(m.group(1))
    return sorted(tuple(k) for k in kernels)


def max_ulps(a, b):
    """The most units in the last place between two float32 tensors of the
    same signs."""
    import torch

    d = (a.contiguous().view(torch.int32).long() - b.contiguous().view(torch.int32).long()).abs()
    return int(d.max())


def compare(names, run, ref_outs, keys, ulps):
    """Each build's outputs against this tree's, then every build timed in
    turns (the reference first, then this tree, the others; then in reverse)."""
    import torch

    import chip_smoke

    readings = {}
    for name in names:
        got = run(name)
        torch.cuda.synchronize()
        readings[name] = {
            "bit_equal": {k: bool(torch.equal(a, b)) for k, a, b in zip(keys, got, ref_outs)},
            "max_abs_diff": {k: float((a - b).abs().max())
                             for k, a, b in zip(keys, got, ref_outs)},
        }
        if ulps:
            readings[name]["max_ulps"] = {k: max_ulps(a, b) for k, a, b in zip(keys, got, ref_outs)}
    order = (["reference"] if "reference" in names else []) + ["this"] + [
        n for n in names if n not in ("reference", "this")]
    order = order + order[::-1]
    ms = {n: [] for n in order}
    for n in order:
        ms[n].append(chip_smoke.cuda_ms(lambda n=n: run(n), 20))
    for n in ms:
        readings[n]["ms"] = ms[n]
    line = "  ".join("%s %s ms bit-equal %s" % (n, "/".join("%.4f" % t for t in ms[n]),
                                                 readings[n]["bit_equal"])
                     for n in ms)
    return readings, line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--direction", choices=("bwd", "fwd"), default="bwd",
                    help="the kernel to compare: the backward (default) or the forward")
    ap.add_argument("--ref", help="a csrc directory holding blackbox_<direction>.cu and its headers")
    ap.add_argument("--rows", type=int, action="append", default=[],
                    help="also build this tree's kernel with this many rows a block")
    ap.add_argument("--no-dw", action="store_true",
                    help="also build this tree's backward without the weights' reduction (timing only)")
    ap.add_argument("--rowwise", action="store_true",
                    help="also build the forward's one-thread-per-row variant")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="also build the csrc directory DIR (32 rows a block) as NAME")
    args = ap.parse_args(argv)
    d = args.direction
    if args.no_dw and d != "bwd" or args.rowwise and d != "fwd":
        ap.error("--no-dw takes the backward, --rowwise the forward")

    import torch

    import chip_smoke
    from vihds_tpu_torch.ops import build, fused_blackbox as fb, fused_ode

    if not torch.cuda.is_available():
        print("blackbox_bwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.phase_card()
    device = torch.device("cuda")
    src = "blackbox_%s.cu" % d
    sources = []  # (name, source file, include dir, rows a block)
    if args.ref:
        sources.append(("reference", os.path.join(args.ref, src), None, 32))
    sources += [("rows%d" % rows, os.path.join(edited_copy(
        "rows%d" % rows, r"^constexpr int BWD_ROWS = \d+;", "constexpr int BWD_ROWS = %d;" % rows),
        src), None, rows) for rows in args.rows]
    if args.no_dw:
        sources.append(("no_dw", os.path.join(edited_copy(
            "no_dw", r"for \(int it = tid / 32; it < N_DW_ITEMS;",
            "for (int it = tid / 32; it < 0;"), src), None, 32))
    if args.rowwise:
        sources.append(("rowwise", ROWWISE, build.CSRC, 32))
    sources += [(v.split("=", 1)[0], os.path.join(v.split("=", 1)[1], src), None, 32)
                for v in args.variant]
    # this tree's source too, built as the others are: every build is timed
    # through the same bare launch (the wrapper's checks and allocations
    # would add to one call's time)
    sources.append(("this", os.path.join(build.CSRC, src), None, fb.BWD_ROWS))
    builds, kernels = {}, {}  # name -> (launch function, rows a block); name -> sass()
    for name, source, include, rows in sources:
        path, lines = build_library("blackbox_%s_%s" % (d, name), source, include)
        builds[name] = (launcher(path, d, source), rows)
        kernels[name] = sass(path)
        for ln in lines:
            print("  %s ptxas: %s" % (name, ln))
    for name in builds:
        if name != "this" and kernels[name] is not None:
            print("  %s SASS equal to this tree's: %s" % (name, kernels[name] == kernels["this"]))

    seed = chip_smoke.SEED + 101  # chip_smoke.py phase 3's operands
    shapes_k = ((chip_smoke.K_TRAIN, seed + 1),) + (((chip_smoke.K_SERVE, seed),) if d == "fwd"
                                                    else ())
    NS = fb.KERNEL_N_STATES
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {"card": card, "direction": d, "shapes": []}
    for K, seed_k in shapes_k:
        _, _, _, wflat, packed, y0_cols, times, shapes = chip_smoke.blackbox_inputs(device, K,
                                                                                    seed_k)
        R, T = packed.shape[1], times.shape[0]
        print("blackbox_%s at K=%d (R=%d, T=%d)" % (d, K, R, T))
        entry = {"K": K, "R": R, "T": T, "methods": {}}
        for mi, method in enumerate(fused_ode.METHODS):
            traj = fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method)
            if d == "fwd":
                def run(name):
                    out = torch.empty_like(traj)
                    err = builds[name][0](*[t.data_ptr() for t in (wflat, packed, y0_cols, times,
                                                                   out)], R, T, mi, stream)
                    if err != 0:
                        raise RuntimeError("%s launch failed with cudaError %d" % (name, err))
                    return (out,)

                readings, line = compare(builds, run, (traj,), ("traj",), True)
            else:
                gen = torch.Generator(device=device).manual_seed(seed + 2)
                g = torch.randn(traj.shape, generator=gen, device=device)

                def run(name):
                    fn, rows = builds[name]
                    parts = torch.empty((-(-R // rows), fb.KERNEL_N_W), device=device)
                    odc, ody0 = torch.empty_like(packed), torch.empty_like(y0_cols)
                    err = fn(*[t.data_ptr() for t in (wflat, packed, times, traj, g, parts, odc,
                                                      ody0)], R, T, mi, stream)
                    if err != 0:
                        raise RuntimeError("%s launch failed with cudaError %d" % (name, err))
                    return parts.sum(dim=0), odc, ody0

                readings, line = compare(builds, run, fb.blackbox_bwd(
                    wflat, packed, times, traj, g, shapes, NS, method), ("dw", "dc", "dy0"), False)
            entry["methods"][method] = readings
            print("%-9s %s" % (method, line))
        result["shapes"].append(entry)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
