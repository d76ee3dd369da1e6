"""Reduce a Chrome trace of ``torch.profiler`` to what the per-layer
metrics read: the device's operations inside the traced window, its busy
time, and the idle gaps named by what the host was doing meanwhile.

A device operation is an event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``.  The traced window is the span of the user annotation
``WINDOW`` that the harness opens around the traced work where the trace
holds host events, else the span from the first device operation to the
last (the harness brackets the work with two device copies).  An idle gap is an
interval of the window in which no device operation runs; it is named by the
innermost host event (an ATen operator, a CUDA runtime call or a user
annotation) that covers its middle, or ``host: no traced op`` where none
does (the interpreter between operators).
"""

import bisect
import json
from collections import defaultdict

WINDOW = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160


class Trace:
    """``ops``: (name, start_us, end_us, category) of the device operations
    in the window; ``window_s``, ``busy_s``; ``gaps``: (host activity,
    seconds) of every idle gap."""

    def __init__(self, events):
        annotated = any(e.get("name") == WINDOW and e.get("cat") == "user_annotation"
                        for e in events)
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("ph") == "X" and "dur" in e
                 and (e.get("name") == WINDOW if annotated else e.get("cat") in DEVICE_CATS)]
        if not spans:
            raise ValueError("trace: no %s annotation and no device operation" % WINDOW)
        w0, w1 = min(a for a, _ in spans), max(b for _, b in spans)
        self.window_s = (w1 - w0) * 1e-6
        self.ops = []
        host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS and t1 > w0 and t0 < w1:
                self.ops.append((e["name"], max(t0, w0), min(t1, w1), cat))
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                host.append((t0, t1, e["name"]))
        self.ops.sort(key=lambda o: o[1])
        busy, gaps, cursor = 0.0, [], w0
        for _, t0, t1, _ in self.ops:
            if t0 > cursor:
                gaps.append((cursor, t0))
            if t1 > cursor:
                busy += t1 - max(t0, cursor)
                cursor = t1
        if cursor < w1:
            gaps.append((cursor, w1))
        self.busy_s = busy * 1e-6
        host.sort()
        starts = [h[0] for h in host]
        self.gaps = [(_host_at(host, starts, 0.5 * (a + b)), (b - a) * 1e-6) for a, b in gaps]

    def kernels(self):
        return [o for o in self.ops if o[3] == "kernel"]

    def kernel_seconds(self, match):
        """(calls, seconds) of the kernels whose name ``match`` accepts."""
        ks = [o for o in self.kernels() if match(o[0])]
        return len(ks), sum(o[2] - o[1] for o in ks) * 1e-6

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        host activity, each [[name, seconds], ...] with at most ``top``."""
        by_op, by_host = defaultdict(float), defaultdict(float)
        for name, t0, t1, _ in self.ops:
            by_op[name[:NAME_CHARS]] += (t1 - t0) * 1e-6
        for name, s in self.gaps:
            by_host[name[:NAME_CHARS]] += s
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(by_host, top)}


def _top(d, n):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(host, starts, t, scan=4096):
    """The innermost host event covering time t: among those that started
    last before t (host sorted by start, ``starts`` their starts), the first
    that has not ended; host events of one thread nest.  Looks back over at
    most ``scan`` events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host: no traced op"


def load(path):
    """A ``Trace`` of the Chrome trace file at ``path``."""
    with open(path) as f:
        data = json.load(f)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
