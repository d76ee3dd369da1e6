"""Plate-reader CSV parser.

The port's own copy of ``vihds_tpu.data.procdata``: it produces the same
(devices, treatments, times, observations) arrays from the same CSV layout
(held against the JAX package in tests/test_torch_host.py).  The layout:

  row 0 after the header holds the observation times ("timesall") from column
  5 on; every later row is one well: [device, colony, well-col, well-row,
  condition-string, <readings...>].  Reading columns are named
  ``<n> (SIGNAL)`` so the signal is recovered from the text between the first
  pair of parentheses.  The condition string looks like ``C6=25000;C12=0``.
"""

import os
import re
from collections import OrderedDict

import numpy as np
import pandas as pd

_PARENTHESISED = re.compile(r"\(([^)]*)\)")


def process_condition(row: str) -> "OrderedDict[str, float]":
    """``'a=b;c=d'`` -> ``{'a': b, 'c': d}`` with float values."""
    d = OrderedDict()
    if "=" not in row:
        return d
    for cond in row.split(";"):
        key, _, val = cond.partition("=")
        try:
            d[key] = float(val)
        except ValueError:
            raise ValueError(
                "Unparseable condition string %r: %r is not a number "
                "(want e.g. 'C6=25000;C12=0')" % (row, val)
            ) from None
    return d


def tabulate_conditions(per_well, conditions):
    """Treatment matrix over the experiment's named ``conditions``.

    A well whose condition string sets any *other* condition to a non-zero
    value belongs to a different experiment and is dropped.  Missing named
    conditions are zero-filled.  Returns (kept row indices,
    values[n_kept, n_conditions]).
    """
    named = set(conditions)
    keep, values = [], []
    for i, well in enumerate(per_well):
        if any(v != 0.0 for k, v in well.items() if k not in named):
            continue
        keep.append(i)
        values.append([well.get(k, 0.0) for k in conditions])
    return keep, np.array(values, dtype=float).reshape(len(keep), len(conditions))


def extract_signal(column_header: str) -> str:
    """Signal name = text inside the header's first ``(...)`` group, falling
    back to the whole header when there is none."""
    match = _PARENTHESISED.search(column_header)
    return match.group(1) if match else column_header


def load(csv_file, settings):
    """Parse one CSV under ``settings.data_dir``.

    Returns ``(devices[L] int, treatments[L,C], times[T], observations[L,S,T])``
    with dtype from ``settings.dtype``.  Returns None when no row matches the
    requested devices.

    Structural problems — a non-CSV or empty file, too few columns, missing
    per-signal reading columns, ragged per-signal column counts — raise
    named ValueErrors instead of cryptic downstream shape errors (the
    serving path feeds user-supplied files through here).
    """
    path = os.path.join(settings.data_dir, csv_file)
    if not os.path.exists(path):
        raise FileNotFoundError(
            "Data CSV %r not found (resolved to %s; the spec's data_dir is %s)"
            % (csv_file, path, settings.data_dir)
        )
    try:
        table = pd.read_csv(path, sep=",", na_filter=False)
    except pd.errors.EmptyDataError:
        raise ValueError("Data CSV %s is empty (no header row)" % path) from None
    if table.shape[1] <= 5 or table.shape[0] < 1:
        raise ValueError(
            "Data CSV %s does not look like plate-reader data (shape %s): "
            "need a time row plus [device, colony, well-col, well-row, "
            "condition, reading...] columns with headers like '600 (OD)'"
            % (path, tuple(table.shape))
        )
    time_row = table.iloc[0, 5:]  # observation times, one per reading column
    wells = table.iloc[1:, :]
    wells = wells[np.isin(wells.iloc[:, 0], settings.devices)]
    if len(wells) == 0:
        return None

    per_well = [process_condition(cond) for cond in wells.iloc[:, 4]]
    keep, treatments = tabulate_conditions(per_well, settings.conditions)

    devices = np.array(
        [settings.device_map[dev] for dev in wells.iloc[keep, 0]], dtype=int
    )

    readings = wells.iloc[keep, 5:]
    # pandas de-duplicates repeated column names as "name.1", "name.2", ...;
    # strip that suffix before recovering each column's signal
    signal_of = np.array(
        [extract_signal(name.split(".")[0]) for name in readings.columns]
    )
    counts = {s: int((signal_of == s).sum()) for s in settings.signals}
    missing = [s for s, c in counts.items() if c == 0]
    if missing or int((signal_of == "OD").sum()) == 0:
        raise ValueError(
            "Data CSV %s has no reading columns for signal(s) %s; found "
            "signals %s (reading columns are named like '600 (OD)'; the "
            "'OD' columns also carry the time grid)"
            % (path, missing or ["OD"], sorted(set(signal_of)))
        )
    if len(set(counts.values())) != 1:
        raise ValueError(
            "Data CSV %s has unequal reading-column counts per signal %s — "
            "every signal needs one column per timepoint" % (path, counts)
        )
    observations = np.stack(
        [
            np.stack([row[signal_of == signal] for signal in settings.signals])
            for row in readings.values
        ]
    )
    times = time_row.values[signal_of == "OD"]

    dtype = {"float32": np.float32, "float64": np.float64}.get(settings.dtype)
    if dtype is None:
        raise ValueError("Unknown dtype %s" % settings.dtype)
    return (
        devices,
        treatments.astype(dtype),
        times.astype(dtype),
        observations.astype(dtype),
    )
