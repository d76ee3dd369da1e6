"""The plate-reader data as the configurations read it, in plain NumPy.

Each CSV has a header row; its first data row holds the observation times
(from column 5 on), and every later row is one well: device, colony, well
column, well row, the condition string (``C6=25000;C12=0``) and the
readings, whose headers name their signal in parentheses.  Wells of other
devices, and wells that set a condition outside the configuration's to a
non-zero value, are dropped.  The files are merged onto the time grid of the
file with the fewest points (each file's nearest points), each signal is
divided by its largest value over all series and each series' minimum is
subtracted.  Treatments enter the model as log(1 + c); devices as one
one-hot block per device group.

The k-fold split, and the shuffled batches of every training epoch, follow
the published code's NumPy recipes: a permutation of the series from the
seed, cut into ``folds`` near-equal parts (fold f holds part f out), and a
permutation of a fold's training series from ``(seed * 1000003 + epoch)
mod 2**32`` for each epoch, the last batch padded with row 0 at mask 0.
"""

import csv
import os
import re

import numpy as np

_SIGNAL = re.compile(r"\(([^)]*)\)")


def _parse(path, data):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, time_row, wells = rows[0], rows[1], rows[2:]
    signal_of = []
    for name in header[5:]:
        m = _SIGNAL.search(name)
        signal_of.append(m.group(1) if m else name)
    signal_of = np.array(signal_of)
    devices, treatments, obs = [], [], []
    for w in wells:
        if w[0] not in data["devices"]:
            continue
        cond = {}
        if "=" in w[4]:
            for part in w[4].split(";"):
                k, _, v = part.partition("=")
                cond[k] = float(v)
        if any(v != 0.0 for k, v in cond.items() if k not in data["conditions"]):
            continue
        devices.append(data["devices"].index(w[0]))
        treatments.append([cond.get(k, 0.0) for k in data["conditions"]])
        vals = np.array([float(v) for v in w[5:5 + len(signal_of)]])
        obs.append(np.stack([vals[signal_of == s] for s in data["signals"]]))
    if not devices:
        return None
    times = np.array([float(v) for v in time_row[5:5 + len(signal_of)]])[signal_of == "OD"]
    return np.array(devices), np.array(treatments, float), times, np.stack(obs)


def _cassettes(devices, data):
    blocks = []
    for group in data["groups"].values():
        depth = len(set(group))
        eye = np.eye(depth)
        blocks.append(eye[[group[d] for d in devices]])
    return np.concatenate(blocks, axis=1)


def relevance(data):
    """name of each device group -> its 0/1 relevance over the one-hot
    blocks (the group's block, without its default device's entry)."""
    out, k = {}, 0
    depth_all = sum(len(set(g)) for g in data["groups"].values())
    defaults = data.get("default_devices") or {}
    for name, group in data["groups"].items():
        d = len(set(group))
        rv = np.zeros(depth_all)
        rv[k:k + d] = 1.0
        if name in defaults:
            rv[k + defaults[name]] = 0.0
        out[name] = rv
        k += d
    return out


def load(data, data_dir):
    """All series: {devices [L], dev_1hot [L, D], inputs [L, C], times [T],
    observations [L, S, T]} in float64."""
    parsed = [p for p in (_parse(os.path.join(data_dir, f), data) for f in data["files"])
              if p is not None]
    devices, treatments, times_list, obs_list = zip(*parsed)
    loc = int(np.argmin([len(t) for t in times_list]))
    times = times_list[loc]
    merged = []
    for t, o in zip(times_list, obs_list):
        idx = [int(np.abs(t - ti).argmin()) for ti in times]
        merged.append(o[:, :, idx])
    obs = np.concatenate(merged)
    obs = obs / obs.max(axis=(0, 2))[None, :, None]
    obs = obs - obs.min(axis=2, keepdims=True)
    devices = np.concatenate(devices)
    return dict(devices=devices, dev_1hot=_cassettes(devices, data),
                inputs=np.log1p(np.concatenate(treatments)), times=times, observations=obs)


def fold_split(n, folds, split, seed):
    """(train ids, held-out ids) of fold ``split`` (1-based), both sorted."""
    perm = np.random.RandomState(seed).permutation(n)
    held = np.sort(np.array_split(perm, folds)[split - 1])
    return np.setdiff1d(np.arange(n), held), held


def epoch_batches(seed, epoch, n_train, n_batch):
    """The batches of one epoch over a fold's training rows: (positions
    [n_batches, n_batch] into the fold's training ids, mask)."""
    perm = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 32)).permutation(n_train)
    n_batches = -(-n_train // n_batch)
    pad = n_batches * n_batch - n_train
    mask = np.ones(n_batches * n_batch)
    if pad:
        mask[n_train:] = 0.0
        perm = np.concatenate([perm, np.zeros(pad, int)])
    return perm.reshape(n_batches, n_batch), mask.reshape(n_batches, n_batch)
