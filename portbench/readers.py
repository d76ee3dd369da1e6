"""What the metric readers under ``metrics/`` share.

A reader ``read(run)`` gets the run's readings: ``mode`` (``train`` or
``eval``), ``setup_s``, ``window_s``, ``units`` (steps or passes completed in
the window) and ``rows_per_unit``; the train window's ``chunk_enqueue_s``,
``chunk_steps`` and ``step_ms`` (the program's CUDA-event marks), the eval
window's ``pass_enqueue_s`` and ``pass_ms`` (the host clock around each
pass);
``shapes`` (``counts``' inputs); and, in a traced run, ``trace`` (a
``trace.Trace`` of the traced segment), ``trace_units`` and ``launches``
(the program's kernel counters over the segment).  It returns None where
the run holds nothing for it to read.
"""

import re

from portbench import counts

#: a hand-written kernel's name -> a test of the profiler's kernel name
KERNELS = {
    "blackbox_fwd": lambda n: "bb::fwd_kernel" in n,
    "blackbox_bwd": lambda n: "bb::bwd_kernel" in n,
    "dr_fwd": lambda n: "bb::" not in n
    and re.search(r"(^|[^A-Za-z_])fwd_kernel<[^>]*\bDr\b", n) is not None,
}


def traced(run):
    """The run's trace where it holds device kernels, else None."""
    tr = getattr(run, "trace", None)
    return tr if tr is not None and tr.kernels() else None


def roofline(run, kernel, mode):
    """``kernel``'s share of its roofline in %: the least time the chip
    could take for the traced calls over their device time."""
    if run.mode != mode or traced(run) is None:
        return None
    calls, seconds = run.trace.kernel_seconds(KERNELS[kernel])
    if not calls:
        return None
    n_bytes, n_flops = counts.kernel_cost(kernel, run.shapes)
    return 100.0 * calls * counts.bound_s(n_bytes, n_flops) / seconds


def launches_per_unit(run, mode):
    if run.mode != mode or traced(run) is None:
        return None
    return len(run.trace.kernels()) / run.trace_units


def idle_share(run, mode):
    """The share of the traced segment with no operation on the device, in
    %: one minus its busy time over its length.  The segment traces the
    device's activity alone, so the profiler adds no per-operator host
    callbacks to the host's pace."""
    if run.mode != mode or traced(run) is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run, mode):
    """The whole step's or pass's share of the float32 peak in %: the
    algorithm's operations (``counts.cell_flops``) over the window's time
    per step or pass."""
    if run.mode != mode or not run.units:
        return None
    per_unit_s = run.window_s / run.units
    return 100.0 * counts.cell_flops(run.shapes, mode == "train") / per_unit_s \
        / counts.FP32_FLOPS_PER_S


def rate(run, mode):
    if run.mode != mode:
        return None
    return run.units * run.rows_per_unit / run.window_s
