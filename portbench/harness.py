"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check against the reference, the metrics.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on the
CPU with smaller sizes (``mix_overrides``), past the look for a card.
"""

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from portbench import check, counts, drive, guard, manifest
from portbench.reference.model import Model


def _shapes(model, mode, F, B, K, n_series, chunk):
    """The cell's shapes as ``counts`` reads them."""
    p = model.params_cfg
    T, n_obs = model.n_times, model.n_obs
    heads = []
    for sites, bias, base in ((model.local, True, p["n_hidden"]), (model.gc, False, 0)):
        if sites:
            d = base + (model.n_cond if sites[0].cond_treatments else 0) \
                + (model.depth if sites[0].cond_devices else 0)
            heads += [(d, len(sites), bias)] * 2
    n_weights = sum(math.prod(shape) for _, shape, _ in model._layouts())
    out = dict(T=T, n_obs=n_obs, n_theta=model.program.n,
               encoder=(n_obs, T, p["n_filters"], p["filter_size"], p["pool_size"],
                        p["n_hidden"], heads),
               R=F * (B if mode == "train" else chunk) * K,
               series=F * B if mode == "train" else n_series,
               rows=(F * B if mode == "train" else n_series) * K,
               n_weights=F * n_weights, n_states_out=model.n_states)
    if model.kind == "dr_blackbox":
        nets = counts.bb_nets(model.n_states, model.n_const, p["n_hidden_decoder"],
                              p["n_hidden_decoder_precisions"])
        n_w = sum(n * h + h + 2 * (h * o + o) for n, h, o, _ in nets)
        out.update(S=model.n_states + counts.N_PREC, n_const=model.n_const, n_w=F * n_w,
                   nets=nets, ode_step_flops=counts.bb_step_flops(nets, model.n_states
                                                                  + counts.N_PREC))
    else:
        out.update(ode_step_flops=counts.step_flops(counts.DR_RHS_FLOPS, counts.DR_VJP_FLOPS,
                                                    model.n_states))
    return out


def _read_metric(name, run, here):
    spec = importlib.util.spec_from_file_location("portbench_metric", manifest.metric_reader(
        name, here))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit():
    """The card's name and power limit as nvidia-smi states them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell_name, seed, seconds, trace, t_start, device="cuda", root=manifest.ROOT,
             mix_overrides=None, control=False, log=sys.stderr):
    """One run of cell ``cell_name``: returns (result dict, check lines).
    ``t_start``: the process's start on ``time.perf_counter``'s clock.
    With ``control`` the result also holds, under ``control``, the numbers
    of the control: the reference in float32 with TF32 matrix products in
    the program's place."""
    man = manifest.load(root)
    cell = manifest.cell(man, cell_name, root)
    mix = dict(cell["traffic"], **(mix_overrides or {}))
    spec = cell["spec"]
    device = torch.device(device)
    from vihds_tpu_torch.utils import resolve_device

    resolve_device(str(device))
    prog = drive.Program(spec, mix, seed, device)
    F, r = mix["folds"], prog.runner
    T = len(r.train_hosts[0].times)
    data_shapes = (len(spec["data"]["signals"]), T, len(spec["data"]["conditions"]),
                   r.model.encoder.depth)
    model32 = Model(spec, data_shapes, torch.float32, device)
    weights = model32.make_params(seed, device)
    prog.load_weights(weights)
    driver = drive.MODES[mix["mode"]](prog, mix, seed)
    driver.setup()
    drive._sync(device)
    setup_s = time.perf_counter() - t_start

    out = driver.window(seconds, time.perf_counter)
    run = SimpleNamespace(mode=mix["mode"], setup_s=setup_s, trace=None, **vars(out))
    n_series = getattr(driver, "n_series", 0)
    run.shapes = _shapes(model32, mix["mode"], F, r.n_batch, mix["samples"], n_series,
                         r.n_batch)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1}
    if trace:
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            run.trace_units, run.trace, gap_trace, run.launches = drive.traced_segment(
                driver, device, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        _launch_note(run, log)
        print("trace: %d %s in %.4f s traced (device only), %.4f s busy"
              % (run.trace_units, "steps" if run.mode == "train" else "passes",
                 run.trace.window_s, run.trace.busy_s), file=log)
    dev_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
    if device.type == "cuda":
        dev_info["power"] = power_limit()

    # the check: the compared passes' log weights read, the program's state
    # freed, the reference after it
    material, n_batch = driver.check, r.n_batch
    if "passes" in material:
        material["passes"] = [(s, ev.want_summaries()) for s, ev in material["passes"]]
    del driver, prog, r
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, detail, control_numbers = reference_numbers(spec, root, mix, seed, weights,
                                                         material, n_batch, device, control)
    correct, lines = check.judge(numbers, cell["limits"])
    print("check: %.1f s; %s" % (time.perf_counter() - t_check, json.dumps(
        dict(detail, **{k: v for k, v in numbers.items() if k not in lines}))), file=log)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell[kind]:
        value = _read_metric(m["name"], run, os.path.join(root, "portbench"))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.units, "failed": run.failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.breakdown()["device_ops"],
                               "idle_gaps": gap_trace.breakdown()["idle_gaps"]}
    result["check_detail"] = dict(detail, **numbers)
    if control:
        result["control"] = control_numbers
    result["check"] = lines
    return result, lines


def reference_numbers(spec, root, mix, seed, weights, material, n_batch, device, control):
    """The cell's numbers against the float64 reference: ({name: value},
    what the look at them needs, and with ``control`` the control's numbers:
    the reference in float32 with TF32 matrix products, on the same inputs,
    put in the program's place).  ``n_batch``: the series of a batch or an
    evaluation chunk."""
    ref = check.Reference(spec, root, mix["folds"], seed, device)
    ctl = (check.Reference(spec, root, mix["folds"], seed, device, torch.float32, tf32=True)
           if control else None)
    K = mix["samples"]
    if mix["mode"] == "eval":
        states = [s for s, _ in material["passes"]]
        refs = [ref.evaluate(weights, s, K, n_batch) for s in states]
        numbers = check.eval_numbers([m for _, m in material["passes"]], refs)
        if not ctl:
            return numbers, {}, None
        return numbers, {}, check.eval_numbers(
            [ctl.evaluate(weights, s, K, n_batch) for s in states], refs)
    w = material["window"]
    resume = (w["params"], w["m"], w["v"], w["t"])

    def follow(side):
        """``side``'s set-up steps and window steps."""
        return (side.train(weights, material["gen0"], K, n_batch, 3),
                side.train(weights, w["gen"], K, n_batch, 3, epoch=w["epoch"], resume=resume)[0])

    ref_out, ref_window = follow(ref)
    p0, p3 = material["p0"], material["p3"]
    grad1 = {k: v.double().cpu() for k, v in material["grad1"].items()}
    change = {k: (p3[k].double() - p0[k].double()).cpu() for k in p0}
    numbers, detail = check.train_numbers(material["losses"], grad1, change, *ref_out,
                                          w["losses"], ref_window)
    if not ctl:
        return numbers, detail, None
    ctl_out, ctl_window = follow(ctl)
    ctl_numbers, ctl_detail = check.train_numbers(*ctl_out, *ref_out, ctl_window, ref_window)
    return numbers, detail, dict(ctl_numbers, detail=ctl_detail)


def _launch_note(run, log):
    """The hand-written kernels' launches in the trace against the
    program's own counters (one forward and one backward a step)."""
    from portbench import readers

    for kernel, n in sorted(run.launches.items()):
        if kernel in readers.KERNELS:
            calls, _ = run.trace.kernel_seconds(readers.KERNELS[kernel])
            note = "" if calls == n else "  MISMATCH"
            print("trace: %s %d launches traced, %d counted by the program over %d %s%s"
                  % (kernel, calls, n, run.trace_units,
                     "steps" if run.mode == "train" else "passes", note), file=log)


def jax_free(log=sys.stderr):
    """True when no JAX module is loaded; names what is, on ``log``."""
    found = guard.forbidden_loaded()
    if found:
        print("portbench: forbidden modules loaded: %s" % ", ".join(found), file=log)
    return not found
