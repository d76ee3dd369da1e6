"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, so a cell, a configuration or a per-layer metric
is added by adding files under ``portbench/`` and entries in
``BENCHMARK.json``:

* ``configs/<config>.json``: the spec as it is run (``spec``), its source,
  and the sizes assumed;
* ``traffic/<traffic>.json``: the mix's parameters, read by ``drive.py``;
* ``cells/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: a reader ``read(run)`` returning the metric's
  value, or None where the run has nothing to read.
"""

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_reader(name, here=HERE):
    """The path of metric ``name``'s reader."""
    return os.path.join(here, "metrics", name + ".py")


def applies(metric, cell, manifest):
    """True when ``metric`` is reported in ``cell``: its ``workloads``, or
    for an end-to-end metric without them every cell, for a per-layer one
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = [m for m in manifest["end_to_end"] if m["name"] == metric["moves"]]
        return bool(moved) and applies(moved[0], cell, manifest)
    return True


def cell(manifest, name, root=ROOT):
    """Cell ``name``: its entry, its configuration's entry and file, its
    traffic's parameters, its limits and the metrics of either kind it
    reports."""
    entry = [w for w in manifest["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError("no cell %r in BENCHMARK.json" % name)
    entry = entry[0]
    config = [c for c in manifest["configs"] if c["name"] == entry["config"]][0]
    here = os.path.join(root, "portbench")
    return dict(
        entry=entry, config=config, spec=_json(root, config["file"])["spec"],
        traffic=_json(here, "traffic", entry["traffic"] + ".json"),
        limits=_json(here, "cells", name + ".json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name, manifest)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name, manifest)])


def problems(manifest, root=ROOT):
    """What in ``manifest`` breaks the benchmark's rules on names, units and
    files (an empty list where nothing does)."""
    out = []
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in manifest[group]:
            names.append((group, item["name"]))
            if not NAME.match(item["name"]):
                out.append("%s name %r" % (group, item["name"]))
    for group in ("configs", "workloads"):
        seen = [n for g, n in names if g == group]
        if len(seen) != len(set(seen)):
            out.append("duplicate %s names" % group)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    if len(metrics) != len(set(metrics)):
        out.append("duplicate metric names")
    for c in manifest["configs"]:
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append("config file %s" % c["file"])
        out += ["reduced key %r" % k for k in c["reduced"] if not NAME.match(k)]
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append("%s %r of %s" % (key, w[key], w["name"]))
        try:
            cell(manifest, w["name"], root)
        except (KeyError, IndexError, OSError) as e:
            out.append("cell %s: %s" % (w["name"], e))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher") \
                or m["source"] not in SOURCES:
            out.append("unit, better or source of %s" % m["name"])
        if not os.path.isfile(metric_reader(m["name"], os.path.join(root, "portbench"))):
            out.append("reader of %s" % m["name"])
    return out
