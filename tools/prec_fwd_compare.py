"""Hold the fused ODE forward kernels, the ``_prec`` kinds' above all,
against a reference build of them on the card.

Builds, besides this tree's ``csrc/<kind>_fwd.cu`` (through
``vihds_tpu_torch.ops.build``), each reference source tree given with
``--ref [NAME=]DIR`` (repeatable; for example an earlier commit's
``vihds_tpu_torch/csrc``, unpacked with ``git archive``, or an edited copy
of it).  For each kind (``--kind``, repeatable; by default all six) and
method it runs every build on chip_smoke.py phase 3's operands at
the training shape (B=36 x K=200) and at the serving chunk (B=36 x K=1000),
T of the kind's spec, says for each state group (species, precisions)
whether each reference's trajectory equals this tree's bit for bit (the
largest difference where not) and each build's largest relative error per
group against the plain version in float64 (as chip_smoke.states_ok reads
it), and times each build with CUDA events in turns: the references, this
tree, the floor, then the same in reverse.  Each turn reads one call (``ms``,
median of 20 calls through its C entry point, the host's launch path
included) and the device's time a call (``device_ms``, 20 launches back to
back), which the host's path does not hide where a kernel is short.  The
floor of a ``_prec`` kind is this tree's plain kind (``dr`` for
``dr_prec``) on the same constants and species: the species chain alone,
which the ``_prec`` kernel's species warp runs; its trajectory should equal
the ``_prec`` kind's species bit for bit, which is reported too.  Prints the ptxas lines of the builds and this tree's block per
method, then one JSON line.

    git archive <commit> vihds_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/prec_fwd_compare.py --ref build/parent/vihds_tpu_torch/csrc
    python3 tools/prec_fwd_compare.py --kind dr --kind relay --kind degrader \
        --ref parent=build/parent/vihds_tpu_torch/csrc --ref rows32=build/rows32

Needs an NVIDIA GPU and nvcc.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

from prec_bwd_compare import build_library, ptxas_lines, single_fold, takes_folds  # noqa: E402


def launcher(path, kind, source):
    """The C entry point of a build of ``<kind>_fwd.cu`` from ``source``,
    called with the arguments of one without the fold count."""
    from vihds_tpu_torch.ops import fused_ode

    n_ptr = 5 if fused_ode.KINDS[kind].prec else 4
    entry = "%s_fwd_launch" % kind
    folds = takes_folds(source, entry)
    fn = getattr(ctypes.CDLL(path), entry)
    p = ctypes.c_void_p
    fn.argtypes = [p] * n_ptr + [ctypes.c_int] * (4 if folds else 3) + [p]
    fn.restype = ctypes.c_int
    return single_fold(fn, folds)


def device_ms(call, reps=20, warmup=3):
    """Milliseconds a call of ``call()`` keeps the device busy: CUDA events
    around ``reps`` calls enqueued back to back after ``warmup`` calls, their
    elapsed time over ``reps`` (``chip_smoke.cuda_ms`` times one call, the
    host's launch path included)."""
    import torch

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def groups(kind):
    """The state groups of ``kind``'s trajectory: [(name, slice)]."""
    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    out = [("species", slice(0, k.n_species))]
    return out + ([("precisions", slice(k.n_species, k.n_states))] if k.prec else [])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", action="append", default=[],
                    help="[NAME=]DIR: a csrc directory holding <kind>_fwd.cu and its headers, "
                         "named NAME (default: reference; repeatable)")
    ap.add_argument("--kind", action="append", default=[],
                    help="a fused kind to compare (default: all six)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from vihds_tpu_torch.ops import build, fused_ode

    kinds = args.kind or list(fused_ode.KINDS)
    for kind in kinds:
        if kind not in fused_ode.KINDS:
            ap.error("no fused kind %r (kinds: %s)" % (kind, ", ".join(fused_ode.KINDS)))
    refs = dict(ref.split("=", 1) if "=" in ref else ("reference", ref) for ref in args.ref)
    if len(refs) < len(args.ref) or {"this", "floor"} & set(refs):
        ap.error("each --ref needs a name of its own, neither 'this' nor 'floor'")
    if not torch.cuda.is_available():
        print("prec_fwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.phase_card()
    device = torch.device("cuda")
    stream = torch.cuda.current_stream(device).cuda_stream
    jobs = [(kind, name, os.path.join(ref, fused_ode.KINDS[kind].fwd + ".cu"))
            for kind in kinds for name, ref in refs.items()]
    sources = {(kind, name): source for kind, name, source in jobs}
    floors = {kind: kind[: -len("_prec")] for kind in kinds if fused_ode.KINDS[kind].prec}
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        # every build at once: nvcc runs in its own process
        built = {(kind, name): pool.submit(build_library, "%s_%s" % (
            fused_ode.KINDS[kind].fwd, name), source)
            for kind, name, source in jobs}
        this_logs = build.build(sorted({fused_ode.KINDS[k].fwd
                                        for k in kinds + list(floors.values())}))
        built = {key: f.result() for key, f in built.items()}

    result = {"card": card, "kinds": {}}
    for kind in kinds:
        k = fused_ode.KINDS[kind]
        builds = {"this": single_fold(fused_ode._launcher(k.fwd, 5 if k.prec else 4),
                                      k.fwd in fused_ode.FOLD_KERNELS)}
        for ln in ptxas_lines(this_logs.get(k.fwd, "")):
            print("  %s this ptxas: %s" % (k.fwd, ln))
        entry = result["kinds"][kind] = {"block": {}}
        for method in fused_ode.METHODS:
            entry["block"][method] = chip_smoke.print_block(
                device, k.fwd + " this", method, fused_ode.fwd_block(kind, method),
                (36 * chip_smoke.K_TRAIN, 36 * chip_smoke.K_SERVE))
        for (kind_, name), (path, lines) in built.items():
            if kind_ == kind:
                builds[name] = launcher(path, kind, sources[kind, name])
                for ln in lines:
                    print("  %s %s ptxas: %s" % (k.fwd, name, ln))
        floor = floors.get(kind)
        if floor:
            builds["floor"] = fused_ode._launcher(fused_ode.KINDS[floor].fwd, 4)
        # chip_smoke.py phase 3's operands: the kind's seed, as main() gives it
        seed = chip_smoke.SEED + 10 * list(fused_ode.KINDS).index(kind) + 1
        for K, seed_k in ((chip_smoke.K_TRAIN, seed + 1), (chip_smoke.K_SERVE, seed)):
            _, _, _, wmat, packed, y0_cols, times = chip_smoke.kind_inputs(device, kind, K, seed_k)
            R, T, S = packed.shape[1], times.shape[0], k.n_states
            print("%s at B=36 x K=%d (R=%d), T=%d; CUDA-event medians of 20 calls and the "
                  "device's time a call, in turns" % (k.fwd, K, R, T))
            shape = entry["K=%d" % K] = {"R": R, "T": T, "methods": {}}
            species0 = y0_cols[: k.n_species].contiguous()

            def launch(name, method):
                """A launch of build ``name`` with its operands and output
                bound: (call, output)."""
                mi = fused_ode.METHODS.index(method)
                if name == "floor":
                    out = torch.empty((T, k.n_species, R), device=device)
                    ptrs = [packed, species0, times, out]
                else:
                    out = torch.empty((T, S, R), device=device)
                    ptrs = ([wmat] if k.prec else []) + [packed, y0_cols, times, out]
                fn, args = builds[name], [t.data_ptr() for t in ptrs] + [R, T, mi, stream]

                def call():
                    err = fn(*args)
                    if err != 0:
                        raise RuntimeError("%s %s launch failed with cudaError %d"
                                           % (k.fwd, name, err))
                return call, out

            def run(name, method):
                call, out = launch(name, method)
                call()
                return out

            for method in fused_ode.METHODS:
                f64 = fused_ode._plain_fwd(kind, wmat.double() if k.prec else None,
                                           packed.double(), y0_cols.double(), times.double(),
                                           method).movedim(1, -1)

                def f64_error(out):  # [species, signals, precisions] against float64
                    return chip_smoke.states_ok(out.movedim(1, -1), f64, kind)[0]

                ref = run("this", method)
                readings = {"this": {"f64_rel_err": f64_error(ref)}}
                for name in builds:
                    if name in ("this", "floor"):
                        continue
                    got = run(name, method)
                    torch.cuda.synchronize()
                    readings[name] = {
                        "bit_equal": {g: bool(torch.equal(got[:, sl], ref[:, sl]))
                                      for g, sl in groups(kind)},
                        "max_abs_diff": {g: float((got[:, sl] - ref[:, sl]).abs().max())
                                         for g, sl in groups(kind)},
                        "f64_rel_err": f64_error(got),
                    }
                del f64
                if floor:
                    got = run("floor", method)
                    torch.cuda.synchronize()
                    readings["floor"] = {"species_bit_equal": bool(torch.equal(
                        got, ref[:, : k.n_species]))}
                again = run("this", method)
                torch.cuda.synchronize()
                readings["this"]["repeat_bit_equal"] = bool(torch.equal(again, ref))
                order = list(refs) + ["this"] + (["floor"] if floor else [])
                for n in order + order[::-1]:
                    readings[n].setdefault("ms", []).append(
                        chip_smoke.cuda_ms(lambda n=n: run(n, method), 20))
                    readings[n].setdefault("device_ms", []).append(
                        device_ms(launch(n, method)[0]))
                shape["methods"][method] = readings

                def note(n):
                    r = readings[n]
                    err = " [float64 rel err %s]" % "/".join(
                        chip_smoke._fmt(x) for x in r.get("f64_rel_err", ()))
                    if n == "this":
                        return " (repeat bit-equal %s)%s" % (r["repeat_bit_equal"], err)
                    if n == "floor":
                        return " (%s species; its trajectory bit-equal %s)" % (
                            floor, r["species_bit_equal"])
                    return " bit-equal %s, largest difference %s%s" % (
                        r["bit_equal"], r["max_abs_diff"], err)
                print("  %-9s %s" % (method, "  ".join(
                    "%s %s ms (device %s)%s" % (
                        n, "/".join("%.4f" % t for t in readings[n]["ms"]),
                        "/".join("%.4f" % t for t in readings[n]["device_ms"]), note(n))
                    for n in order)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
