"""How a run's ``correct`` is decided: what the timed path produced, held
against the frozen reference (``portbench/reference``, float64) computed
from the same weights, data, draws and batches.

Evaluation cells compare, on two of the window's passes (the last, and one
chosen by the seed), every held-out series of every fold: its per-item ELBO,
IWAE log weights, q's mean and precision, the clipped draws, and the
importance-weighted predictive mean and standard deviation and states
(``eval_numbers``).  Each number is the widest gap over series, a series'
largest absolute gap over its own largest reference value or the median
series' largest value, whichever is larger; the weighted moments are also
read at the median series (``<key>_med``).  A cell judges the numbers its
limits name (``cells/<cell>.json``): at the benchmark's random weights the
log weights are ~1e4 nats, so float32's relative 1e-6 on them is ~0.01 nats
and can move the widest series' weighted moments as far as the control
does; where it does, the moment is judged at the median series.  The
standard deviation is read and not judged: it is sqrt(E_w[x^2 + 1 / prec]
- mean^2), and where it is far below the mean float32's rounding of that
difference, which the control shares, outweighs anything the control adds.

Training cells follow two stretches of the steps the window's own call
(``VmapXval.train_steps``) takes.  The set-up's first three steps, from the
benchmark's weights and a fresh optimizer: each step's loss per fold
(relative gap), and for each leaf (each fold's slice of a param leaf is a
leaf) the gap between the program's and the reference's norms of the first
step's gradient (read from Adam's first moment) and of the params' change
over the three steps, over the reference's norm of that leaf or the median
leaf's, whichever is larger.  And the first three steps of the window's
first chunk (a chunk as long as every window chunk, on the epoch's own
index grid), which the reference takes from the program's params and Adam
moments as the window found them: each step's loss per fold.  Judged are
the first step's loss of each stretch (worst fold), the later steps' worst
loss, and both norms at the median leaf; each norm's worst leaf is reported
beside them.  Adam's first steps move each entry by about the learning rate
whatever its size, so an entry whose float32 gradient is rounding can flip,
and a global site's gradient is a float32 sum over every row and draw that
cancels: on a few seeds in forty one leaf's first gradient or one leaf's
change read as far from the reference as the control does, while the median
leaf reads alike on every seed.  The change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's: Adam moves
them by round-off alone.
"""

import math
import os

import numpy as np
import torch

from portbench.reference import data as refdata
from portbench.reference.model import Adam, Model, leaves, learning_rate

#: the importance-weighted moments, read at the widest and the median series
MOMENTS = ("iw_predict_mu", "iw_predict_std", "iw_states")
#: a leaf whose reference gradient is under this share of the median leaf's
#: takes no part in the change
GRAD_FLOOR = 1e-3


class Reference:
    """The reference model and data of one configuration, in ``dtype`` on
    ``device``; ``tf32`` computes its float32 matrix products in TF32 (the
    control)."""

    def __init__(self, spec, root, folds, seed, device, dtype=torch.float64, tf32=False):
        self.data = refdata.load(spec["data"], os.path.join(root, "data"))
        obs = self.data["observations"]
        shapes = (obs.shape[1], obs.shape[2], self.data["inputs"].shape[1],
                  self.data["dev_1hot"].shape[1])
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.model = Model(spec, shapes, dtype, self.device)
        self.seed = seed
        self.splits = [refdata.fold_split(obs.shape[0], folds, f + 1, seed) for f in range(folds)]

    def batch(self, ids):
        t = {k: torch.as_tensor(self.data[k][ids], dtype=self.dtype, device=self.device)
             for k in ("observations", "inputs", "dev_1hot")}
        t["times"] = torch.as_tensor(self.data["times"], dtype=self.dtype, device=self.device)
        return t

    def _tf32(self, on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def evaluate(self, weights, state, K, chunk):
        """The outputs of one pass whose draws came from a generator in
        ``state``: per fold a dict of numpy arrays over its held-out series."""
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        n_theta = self.model.program.n
        n_chunks = math.ceil(max(len(h) for _, h in self.splits) / chunk)
        us = [torch.randn((chunk, K, n_theta), generator=gen, device=self.device).to(self.dtype)
              for _ in range(n_chunks)]
        w = self.model.cast(weights)
        self._tf32(self.tf32)
        outs = []
        with torch.no_grad():
            for _, held in self.splits:
                ids = np.concatenate([held, np.full(n_chunks * chunk - len(held), held[0])])
                parts = [self.model.evaluate(w, self.batch(ids[c * chunk:(c + 1) * chunk]), us[c])
                         for c in range(n_chunks)]
                outs.append({k: torch.cat([p[k] for p in parts], dim=1 if k == "theta" else 0)
                             .narrow(1 if k == "theta" else 0, 0, len(held))
                             .double().cpu().numpy() for k in parts[0]})
        self._tf32(False)
        return outs

    def train(self, weights, state, K, n_batch, steps, epoch=1, resume=None):
        """Each fold's first ``steps`` steps of epoch ``epoch``, with draws from
        a generator in ``state``: from ``weights`` (one fold's tree, where
        every fold starts) and a fresh optimizer, or with ``resume`` = (params,
        m, v, t) from each fold's own params and Adam moments ({path: [F,
        ...]}) after ``t`` steps.  Returns (losses [steps, F], {path: first
        gradient [F, ...]}, {path: change [F, ...]})."""
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        n_theta = self.model.program.n
        us = [torch.randn((n_batch, K, n_theta), generator=gen, device=self.device).to(self.dtype)
              for _ in range(steps)]
        w0 = leaves(self.model.cast(weights))
        paths = [p for p, _ in w0]
        cfg = self.model.params_cfg
        if cfg.get("grad_clip_norm"):
            raise ValueError("reference: grad_clip_norm is not supported")
        losses, grads, deltas = [], [], []
        self._tf32(self.tf32)
        for f, (train_ids, _) in enumerate(self.splits):
            pos, mask = refdata.epoch_batches(self.seed, epoch, len(train_ids), n_batch)
            n_batches = pos.shape[0]
            if resume is None:
                x0, adam, t0 = [x for _, x in w0], Adam(len(w0)), 0
            else:
                params, m, v, t0 = resume
                fold = lambda tree: [self.model.cast(tree[p][f]) for p in paths]
                x0, adam = fold(params), Adam(len(w0), fold(m), fold(v), t0)
            xs = [x.clone().requires_grad_(True) for x in x0]
            fold_losses = []
            for s in range(steps):
                loss = self.model.loss(_tree(paths, xs), self.batch(train_ids[pos[s]]),
                                       torch.as_tensor(mask[s], dtype=self.dtype,
                                                       device=self.device), us[s])
                g = torch.autograd.grad(loss, xs, allow_unused=True)
                g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(xs, g)]
                if s == 0:
                    grads.append([gi.detach() for gi in g])
                fold_losses.append(float(loss.detach()))
                xs = [x.detach().requires_grad_(True)
                      for x in adam.step([x.detach() for x in xs], g,
                                         learning_rate(cfg, n_batches, t0 + s))]
            losses.append(fold_losses)
            deltas.append([x.detach() - x_start for x, x_start in zip(xs, x0)])
        self._tf32(False)
        stack = lambda per_fold: {p: torch.stack([f[i] for f in per_fold]).double().cpu()
                                  for i, p in enumerate(paths)}
        return torch.tensor(losses, dtype=torch.float64).t(), stack(grads), stack(deltas)


def _tree(paths, xs):
    tree = {}
    for path, x in zip(paths, xs):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def series_gaps(ours, ref):
    """Each series' (axis 0) largest absolute gap over its largest reference
    value or the median series', whichever is larger."""
    n = ref.shape[0]
    d = np.abs(np.asarray(ours, np.float64) - ref).reshape(n, -1).max(axis=1)
    s = np.abs(ref).reshape(n, -1).max(axis=1)
    return d / np.maximum(np.maximum(s, np.median(s)), 1e-300)


def eval_numbers(ours, refs):
    """The eval cell's numbers over the compared passes: ``ours`` and
    ``refs`` are lists (one a pass) of lists (one a fold) of output dicts;
    theta is [n_theta, series, K] in both.  Each is the widest series gap;
    the weighted moments also at the median series (``<key>_med``): where
    the importance weights tie, float32 log weights of ~1e4 nats move a
    series' moments by more than any error of its draws."""
    gaps = {}
    for passes_ours, passes_ref in zip(ours, refs):
        for o, r in zip(passes_ours, passes_ref):
            for k in ("per_item_elbo", "log_w", "q_mu", "q_prec", "theta") + MOMENTS:
                a, b = np.asarray(o[k]), r[k]
                if k == "theta":
                    a, b = np.moveaxis(a, 1, 0), np.moveaxis(b, 1, 0)
                gaps.setdefault("elbo" if k == "per_item_elbo" else k, []).append(
                    series_gaps(a, b))
    out = {k: float(np.max(np.concatenate(v))) for k, v in gaps.items()}
    for k in MOMENTS:
        out[k + "_med"] = float(np.median(np.concatenate(gaps[k])))
    return out


def _leaf_norms(tree):
    """{(path, fold): norm} of [F, ...] leaves."""
    return {(p, f): float(torch.linalg.vector_norm(v[f]))
            for p, v in tree.items() for f in range(v.shape[0])}


def _norm_gaps(ours, ref, keep=None):
    """{(path, fold): gap} of two norm dicts, each over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(ours[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keys}


def _worst(gaps):
    k = max(gaps, key=gaps.get)
    return "%s fold %d" % ("/".join(k[0]), k[1] + 1)


def _loss_gaps(losses, ref_losses):
    """Each step's widest relative loss gap over the folds: [steps, F] in."""
    return ((losses.double() - ref_losses).abs() / ref_losses.abs()).max(dim=1).values


def train_numbers(losses, grad1, change, ref_losses, ref_grad1, ref_change, window, ref_window):
    """The training cell's numbers: ``losses`` [steps, F] of the set-up's
    first steps; the others {path: [F, ...]} of the program and of the
    reference; ``window`` and ``ref_window`` [steps, F], the losses of the
    window's first chunk's first steps.  ``loss``: the set-up's first step's
    widest gap over the folds; ``loss_window``: the window's; ``loss_later``:
    the widest of the later steps' of both; ``grad`` and ``change``: the
    median leaf's gap (each fold's slice of a param leaf is a leaf).  Also
    returns what the look at a reading needs: each step's widest loss gap,
    the worst leaf's gap of either norm and its name, and the leaves left out
    of the change."""
    loss_gaps, window_gaps = _loss_gaps(losses, ref_losses), _loss_gaps(window, ref_window)
    g_ours, g_ref = _leaf_norms(grad1), _leaf_norms(ref_grad1)
    med = float(np.median(list(g_ref.values())))
    keep = {k for k, v in g_ref.items() if v >= GRAD_FLOOR * med}
    grad = _norm_gaps(g_ours, g_ref)
    change = _norm_gaps(_leaf_norms(change), _leaf_norms(ref_change), keep)
    numbers = dict(loss=float(loss_gaps[0]), loss_window=float(window_gaps[0]),
                   loss_later=float(torch.cat([loss_gaps[1:], window_gaps[1:]]).max()),
                   grad=float(np.median(list(grad.values()))),
                   change=float(np.median(list(change.values()))))
    detail = dict(loss_by_step=[float(x) for x in loss_gaps],
                  window_loss_by_step=[float(x) for x in window_gaps],
                  grad_worst_leaf=max(grad.values()), grad_worst=_worst(grad),
                  change_worst_leaf=max(change.values()), change_worst=_worst(change),
                  left_out=sorted({"/".join(k[0]) for k in g_ref if k not in keep}))
    return numbers, detail


def judge(numbers, limits):
    """(correct, {name: {value, limit}}): correct when every number is
    finite and at most its limit."""
    lines = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limits[k]
             for k in limits)
    return ok, lines
