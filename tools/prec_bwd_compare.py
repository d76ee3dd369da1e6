"""Hold the fused ODE backward kernels, of the plain kinds and of the
``_prec`` kinds, against other builds of them on the card.

Builds, besides this tree's ``csrc/<kind>_bwd.cu`` (through
``vihds_tpu_torch.ops.build``), a reference source tree given with ``--ref``
(for example an earlier commit's ``vihds_tpu_torch/csrc``, unpacked with
``git archive``); with ``--no-dw`` this tree's ``_prec`` kernel without the
precision warps' accumulation of the weight cotangent (what that costs: it
computes everything else); with ``--no-prec`` this tree's ``_prec`` kernel
with the precision warps' arithmetic removed (no features, dot products,
sigmoids, df or dW; the tiles, barriers and the species warp's work stay:
what the block's protocol and the species' chain cost alone; timing only).
For each kind (``--kind``, repeatable; by default ``dr_prec``,
``relay_prec`` and ``degrader_prec``; a plain kind such as ``dr`` is
compared the same way, without dW), cotangent and method it runs every
build at the training shape (B=36 x K=200, T of the kind's spec), says
whether dW (the sum of the per-block partials, as the wrapper takes it), dc
and dy0 equal this tree's bit for bit (the largest difference where not),
and times each build with CUDA events (median of 20 launches, each through
its C entry point and the sum over the partials) in turns: reference, this
tree, the edited builds, then the same in reverse.  The cotangent
(``--cotangent``, repeatable; ``random`` by default) is chip_smoke.py phase
3's seeded random one on its operands (``random``), or the one a
kernel-route training step of the kind's spec hands the kernel, mostly exact
zeros, on that step's constants and initial states (``step``,
``chip_smoke.step_operands``; the plain relay / degrader kinds take the
species rows of their ``_prec`` spec's); the trajectory is integrated from
those for each method.  Prints the ptxas lines of the builds, then one JSON
line.

    git archive <commit> vihds_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/prec_bwd_compare.py --ref build/parent/vihds_tpu_torch/csrc --no-dw --no-prec
    python3 tools/prec_bwd_compare.py --ref build/parent/vihds_tpu_torch/csrc --kind dr \
        --cotangent random --cotangent step

Needs an NVIDIA GPU and nvcc.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "build", "prec_compare")
PREC_KINDS = ("dr_prec", "relay_prec", "degrader_prec")
# the precision warps' accumulation of the weight cotangent (dr_common.cuh, PrecWarp)
ACCUMULATE = r"\n *dWp\[k\] \+= dp \* fm\[k\];\n *dWd\[k\] \+= dd \* fm\[k\];"
# ... and the rest of their arithmetic: (pattern, replacement) edits of PrecWarp
PREC_ARITHMETIC = [
    (ACCUMULATE, ""),
    (r"= tanhf\(e == 0 \? t : x\);", "= 0.0f;"),  # keeps the species' share finite
    (r"\n *p \+= Wp\[k\] \* fm\[k\];\n *d \+= Wd\[k\] \* fm\[k\];", ""),
    (r"sp\[M\] = sigmoidf\(p\);\n *sd\[M\] = sigmoidf\(d\);", "sp[M] = p;\n    sd[M] = d;"),
    (r"df \+= Wk\[i\] \* dpd\[i\] \+ Wk\[N_PREC \+ i\] \* dpd\[N_PREC \+ i\];", ";"),
]


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_library(name, source):
    """nvcc ``source`` with the port's flags into build/prec_compare/lib<name>.so;
    returns (path, ptxas lines)."""
    from vihds_tpu_torch.ops import build

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "lib%s.so" % name)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", path, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc %s failed:\n%s" % (name, log))
    return path, ptxas_lines(log)


def edited_copy(name, edits):
    """A copy of this tree's csrc under build/prec_compare/ with each
    (pattern, replacement) of ``edits`` made in dr_common.cuh (once each)."""
    from vihds_tpu_torch.ops import build

    dst = os.path.join(OUT, "csrc_" + name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    header = os.path.join(dst, "dr_common.cuh")
    src = open(header).read()
    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError("%s: %d matches of %r in %s" % (name, n, pattern, header))
    open(header, "w").write(src)
    return dst


def launcher(path, kind):
    """The C entry point of a build of ``<kind>_bwd.cu``."""
    from vihds_tpu_torch.ops import fused_ode

    n_ptr = 8 if fused_ode.KINDS[kind].prec else 6
    fn = getattr(ctypes.CDLL(path), "%s_bwd_launch" % kind)
    p = ctypes.c_void_p
    fn.argtypes = [p] * n_ptr + [ctypes.c_int] * 3 + [p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", help="a csrc directory holding <kind>_bwd.cu and its headers")
    ap.add_argument("--kind", action="append", default=[],
                    help="a fused kind to compare (default: the three _prec kinds)")
    ap.add_argument("--no-dw", action="store_true",
                    help="also build this tree's _prec kernels without the weight cotangent "
                         "(timing only)")
    ap.add_argument("--no-prec", action="store_true",
                    help="also build this tree's _prec kernels without the precision warps' "
                         "arithmetic (timing only)")
    ap.add_argument("--cotangent", action="append", choices=("random", "step"), default=[],
                    help="the cotangent to run the builds on (default: random)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from vihds_tpu_torch.ops import build, fused_ode

    kinds = args.kind or list(PREC_KINDS)
    for kind in kinds:
        if kind not in fused_ode.KINDS:
            ap.error("no fused kind %r (kinds: %s)" % (kind, ", ".join(fused_ode.KINDS)))
    if not torch.cuda.is_available():
        print("prec_bwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.phase_card()
    device = torch.device("cuda")
    trees = ([("reference", args.ref)] if args.ref else []) + (
        [("no_dw", edited_copy("no_dw", [(ACCUMULATE, "")]))] if args.no_dw else []) + (
        [("no_prec", edited_copy("no_prec", PREC_ARITHMETIC))] if args.no_prec else [])
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {"card": card, "kinds": {}}
    jobs = [(kind, name, tree) for kind in kinds for name, tree in trees
            if name not in ("no_dw", "no_prec") or fused_ode.KINDS[kind].prec]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        # every build at once: nvcc runs in its own process
        built = {}
        for kind, name, tree in jobs:
            bwd = fused_ode.KINDS[kind].bwd
            built[kind, name] = pool.submit(build_library, "%s_%s" % (bwd, name),
                                            os.path.join(tree, bwd + ".cu"))
        this_logs = build.build([fused_ode.KINDS[kind].bwd for kind in kinds])
        built = {key: f.result() for key, f in built.items()}
    for kind in kinds:
        k = fused_ode.KINDS[kind]
        builds = {"this": fused_ode._launcher(k.bwd, 8 if k.prec else 6)}
        for ln in ptxas_lines(this_logs.get(k.bwd, "")):
            print("  %s this ptxas: %s" % (k.bwd, ln))
        for (kind_, name), (path, lines) in built.items():
            if kind_ == kind:
                builds[name] = launcher(path, kind)
                for ln in lines:
                    print("  %s %s ptxas: %s" % (k.bwd, name, ln))

        # chip_smoke.py phase 3's operands: the kind's seed, as main() gives it
        seed = chip_smoke.SEED + 10 * list(fused_ode.KINDS).index(kind) + 1
        result["kinds"][kind] = {}
        for cotangent in args.cotangent or ["random"]:
            if cotangent == "random":
                _, _, _, wmat, packed, y0_cols, times = chip_smoke.kind_inputs(
                    device, kind, chip_smoke.K_TRAIN, seed + 1)
                g_step = None
            else:
                wmat, packed, times, y0_cols, g_step = chip_smoke.step_operands(device, kind)
            R, T, S = packed.shape[1], times.shape[0], k.n_states
            entry = result["kinds"][kind][cotangent] = {"R": R, "T": T, "methods": {}}
            if g_step is not None:
                entry["zero_share"] = float((g_step == 0).double().mean())
                entry["subnormal_share"] = float(
                    ((g_step != 0) & (g_step.abs() < chip_smoke.FLT_MIN)).double().mean())
            print("%s at B=36 x K=%d (R=%d), T=%d, %s cotangent%s; CUDA-event medians of 20 "
                  "launches, in turns"
                  % (k.bwd, chip_smoke.K_TRAIN, R, T, cotangent,
                     " (%.4f of it exactly zero, %.4f subnormal)"
                     % (entry["zero_share"], entry["subnormal_share"]) if g_step is not None
                     else ""))
            for mi, method in enumerate(fused_ode.METHODS):
                with torch.no_grad():
                    traj = fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)
                    if g_step is None:
                        gen = torch.Generator(device=device).manual_seed(seed + 2)
                        g = torch.randn(traj.shape, generator=gen, device=device)
                    else:
                        g = g_step

                def run(name):
                    parts = (torch.empty((-(-R // fused_ode.PREC_BWD_ROWS),) + k.wmat_shape,
                                         device=device) if k.prec else None)
                    dc, dy0 = torch.empty_like(packed), torch.empty((S, R), device=device)
                    ptrs = ([wmat.data_ptr()] if k.prec else []) + [
                        t.data_ptr() for t in (packed, times, traj, g)] + (
                        [parts.data_ptr()] if k.prec else []) + [dc.data_ptr(), dy0.data_ptr()]
                    err = builds[name](*ptrs, R, T, mi, stream)
                    if err != 0:
                        raise RuntimeError("%s %s launch failed with cudaError %d"
                                           % (k.bwd, name, err))
                    return ({"dW": parts.sum(dim=0)} if k.prec else {}) | {"dc": dc, "dy0": dy0}

                ref = run("this")
                readings = {"this": {}}
                for name in builds:
                    if name == "this":
                        continue
                    got = run(name)
                    torch.cuda.synchronize()
                    readings[name] = {
                        "bit_equal": {o: bool(torch.equal(got[o], ref[o])) for o in ref},
                        "max_abs_diff": {o: float((got[o] - ref[o]).abs().max()) for o in ref},
                    }
                again = run("this")
                torch.cuda.synchronize()
                readings["this"]["repeat_bit_equal"] = all(torch.equal(again[o], ref[o])
                                                           for o in ref)
                order = (["reference"] if "reference" in builds else []) + ["this"] + [
                    n for n in builds if n not in ("reference", "this")]
                for n in order + order[::-1]:
                    readings[n].setdefault("ms", []).append(
                        chip_smoke.cuda_ms(lambda n=n: run(n), 20))
                entry["methods"][method] = readings
                print("  %-9s %s" % (method, "  ".join(
                    "%s %s ms%s" % (n, "/".join("%.4f" % t for t in readings[n]["ms"]),
                                    " bit-equal %s, largest difference %s" % (
                                        readings[n]["bit_equal"], readings[n]["max_abs_diff"])
                                    if n != "this" else
                                    " (repeat bit-equal %s)" % readings[n]["repeat_bit_equal"])
                    for n in order)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
