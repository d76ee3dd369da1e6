"""All k folds of a cross-validation in one batched step: the port of
``vihds_tpu/xfold.py`` (``call_run_xval --vmap_folds``).

The JAX package runs the folds as a leading ``jax.vmap`` axis of its train
and eval steps.  Here the fold axis is explicit (``torch.func`` cannot carry
the step: ``integrate_fold``'s checkpointing and the kernels'
``autograd.Function`` s are refused under ``vmap``):

* every param leaf and each Adam moment has a leading ``[F]`` axis; the
  folds start from the one init the sequential driver draws from the seed;
* the rows of a step are the F folds' batches, fold-major (fold f's rows are
  ``[f * B, (f + 1) * B)``), so the right-hand sides, the kernels' per-row
  constants, the log-likelihoods and the draws ``u`` cover every fold at
  once; the layers run each fold's rows on its own weights (``nn.layers``),
  and the ``_prec`` and black-box kernels take each fold's weights through
  their fold grid axis (one launch for all folds);
* nothing reduces across folds: one loss per fold (their sum's gradient is
  each fold's own), one gradient-norm clip per fold, a NaN fold frozen
  without touching the others.

Random draws: the sequential driver starts every fold from the same seed,
its training generator draws ``u [B, K, n_theta]`` each step and each
evaluation draws from a generator of (seed, epoch) chunk by chunk.  With the
equal batch and eval-chunk grids this runner requires, every fold draws the
same ``u`` at every step and every evaluation chunk, so one generator whose
draw is shared by the folds gives each fold the draws of its sequential run
(``run_xval.run_on_split(split=f + 1)``).

Falls back to the sequential driver, with the JAX package's printed reason,
for ``merge: false`` data, ``--heldout``, fewer than 2 folds and folds whose
padded batch or eval-chunk counts differ.  Adaptive solvers and
``adjoint_solver: true`` stop before training: the per-fold step controller
they need is a ROADMAP item.  Checkpoints of the stacked state go to
``checkpoints_vmap/`` (params, Adam state, the generator, the epoch and the
per-fold ``alive`` mask); a resumed run replays ``epoch_perm(seed, e)``.

With ``--mesh auto`` the folds spread over the local cards
(``make_fold_mesh``, the JAX package's fold mesh): each card takes an equal,
contiguous group of folds with its own stacked params, optimizer, training
generator and data, and runs the batched step on them.  The folds never
meet, so nothing crosses cards but the evaluations' outputs; each group's
generator is seeded as the one generator is and draws the same u, so every
fold sees the draws of the unsharded run.
"""

import copy
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from vihds_tpu_torch import checkpoint as ckpt
from vihds_tpu_torch import plotting_hooks, profiling
from vihds_tpu_torch.data.datasets import build_datasets
from vihds_tpu_torch.ops.solvers import ADAPTIVE_SOLVERS
from vihds_tpu_torch.prob import ParamProgram, parse_parameters
from vihds_tpu_torch.results import Results
from vihds_tpu_torch.training import (
    HostWorker,
    Optimizer,
    Training,
    TrainingLogData,
    build_epoch_stacks,
    dreg_value_and_grad,
    elapsed_ms,
    eval_step,
    loss_fn,
    make_results,
    param_leaves,
    run_on,
    update_summaries,
)
from vihds_tpu_torch.utils import resolve_device, summary_writer
from vihds_tpu_torch.utils.attrdict import AttrDict
from vihds_tpu_torch.vae import VAE

#: the ROADMAP item that ports the per-fold adaptive step controller
ADAPTIVE_ITEM = "per-fold adaptive step control under --vmap_folds"


class FoldMesh:
    """A 1-D ('fold',) mesh: the devices the folds spread over, each taking
    an equal, contiguous group of folds."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.shape = {"fold": len(self.devices)}


def local_devices(device):
    """The devices of this process of ``device``'s type: every visible card,
    or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_fold_mesh(folds, devices):
    """A ('fold',) mesh over the largest count of ``devices`` that divides
    ``folds``: the fold axis is embarrassingly parallel (folds never
    communicate).  None when only one device would be used."""
    n_dev = 1
    for d in range(min(folds, len(devices)), 1, -1):
        if folds % d == 0:
            n_dev = d
            break
    if n_dev < 2:
        return None
    return FoldMesh(devices[:n_dev])


def _map_params(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_params(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _cat_opt_states(states, device):
    """One ``Optimizer.state_dict`` of the folds of ``states`` (the groups'
    optimizers, in fold order): the Adam moments joined along the fold axis."""
    adam = states[0]["adam"]
    joined = {}
    for i, st in adam["state"].items():
        joined[i] = {k: (torch.cat([s["adam"]["state"][i][k].to(device) for s in states])
                         if k != "step" else v) for k, v in st.items()}
    return {"adam": {"state": joined, "param_groups": adam["param_groups"]},
            "count": states[0]["count"]}


def _slice_opt_state(state, lo, hi):
    """Folds ``lo .. hi`` of a stacked ``Optimizer.state_dict``."""
    adam = state["adam"]
    return {"adam": {"state": {i: {k: v if k == "step" else v[lo:hi] for k, v in st.items()}
                               for i, st in adam["state"].items()},
                     "param_groups": adam["param_groups"]},
            "count": state["count"]}


def stack_params(params, n_folds):
    """A param tree with a leading fold axis: ``n_folds`` copies of each leaf."""
    if isinstance(params, dict):
        return {k: stack_params(v, n_folds) for k, v in params.items()}
    return torch.stack([params] * n_folds).contiguous()


class FoldLazyEval:
    """One split's evaluation of every fold, kept on the device chunk by
    chunk and read per key on demand: each read is one transfer covering
    every fold, and only the keys a boundary uses move (the scalars always,
    the summaries' terms where a writer is open, the predictive moments and
    theta where a fold improved or a figure is due).  ``merged[f]`` holds
    fold f's numpy arrays (None for a NaN-frozen fold)."""

    SCALAR_KEYS = ("per_item_elbo",)
    SUMMARY_KEYS = ("log_w", "log_p_obs", "log_q", "log_p", "log_p_by_species", "q_mu",
                    "q_prec")
    RESULT_KEYS = ("q_mu", "q_prec", "iw_predict_mu", "iw_predict_std", "iw_states",
                   "iw_variance", "theta_bkn")

    def __init__(self, chunks, ns, alive):
        self._chunks = chunks  # key -> [n_chunks tensors of F * chunk rows]
        self._ns = ns
        self.merged = [AttrDict() if a else None for a in alive]

    def _fetch(self, key):
        parts = self._chunks.pop(key, None)
        if parts is None:
            return
        n_folds = len(self._ns)
        v = torch.stack(parts)  # [n_chunks, F * chunk, ...]
        v = v.view(v.shape[0], n_folds, -1, *v.shape[2:]).transpose(0, 1)
        v = v.reshape(n_folds, -1, *v.shape[3:]).cpu().numpy()  # one transfer
        for f, m in enumerate(self.merged):
            if m is None:
                continue
            part = v[f, :self._ns[f]]
            if key == "theta_bkn":
                m["theta"] = np.transpose(part, (2, 0, 1))  # [n_theta, B, K]
            else:
                m[key] = part

    def _want(self, keys):
        for k in keys:
            self._fetch(k)
        return self.merged

    def want_scalars(self):
        self._want(self.SCALAR_KEYS)
        for m in self.merged:
            if m is not None and "elbo" not in m:
                m["elbo"] = float(np.mean(m["per_item_elbo"]))
        return self.merged

    def want_summaries(self):
        return self._want(self.SUMMARY_KEYS)

    def want_results(self):
        return self._want(self.RESULT_KEYS)


class UnsupportedVmapXval(ValueError):
    """The batched driver cannot express this configuration exactly; the
    caller falls back to the sequential fold loop.  A type of its own, so
    that ``run_all_folds`` does not swallow other configuration errors."""


def unsupported_reason(args, settings):
    """None if the batched driver can run this configuration, else why not
    (the JAX package's reasons, word for word)."""
    if not settings.data.merge:
        return "merge: false datasets group by file, not by fold"
    if getattr(args, "heldout", None):
        return "--heldout is a single split, not a k-fold"
    if args.folds < 2:
        return "needs folds >= 2"
    return None


def check_fixed_grid(settings):
    """Stop, before any work, where the spec integrates with an adaptive
    method or the continuous adjoint: their step controller needs a step
    size per fold, not yet ported."""
    p = settings.params
    for key in ("solver", "eval_solver"):
        method = p.get(key)
        if method in ADAPTIVE_SOLVERS:
            raise SystemExit('--vmap_folds with %s: %s is not ported to vihds_tpu_torch yet '
                             '(ROADMAP queue 1, "%s")' % (key, method, ADAPTIVE_ITEM))
    if p.get("adjoint_solver"):
        raise SystemExit('--vmap_folds with adjoint_solver: true is not ported to '
                         'vihds_tpu_torch yet (ROADMAP queue 1, "%s")' % ADAPTIVE_ITEM)


class VmapXval:
    """All k folds of a cross-validation as one batched training run on
    ``device``, or spread over the devices of ``fold_mesh`` (``FoldMesh``),
    one group of folds a device."""

    def __init__(self, args, settings, device="cuda", fold_mesh=None):
        self.args = args
        self.settings = settings
        self.device = device
        self.folds = args.folds
        self.fold_mesh = fold_mesh

        self.pairs = []
        for split in range(1, self.folds + 1):
            a = copy.copy(args)
            a.heldout = None
            a.split = split
            self.pairs.append(build_datasets(a, settings))

        self.program = ParamProgram(parse_parameters(settings.params))
        self.model = VAE(settings, self.pairs[0], self.program)

        p = settings.params
        self.n_batch = min(p.n_batch, min(pair.n_train for pair in self.pairs))
        batch_counts = {math.ceil(pair.n_train / self.n_batch) for pair in self.pairs}
        if len(batch_counts) != 1:
            # padding a shorter fold up to a larger batch count would make a
            # fully masked batch (0/0 ELBO); the sequential driver handles it
            raise UnsupportedVmapXval(
                "folds have unequal padded batch counts %s" % sorted(batch_counts))
        self.n_batches = batch_counts.pop()
        # a common eval chunk grid too: a fold padded up to more chunks than
        # its sequential run takes would draw more u from the eval generator
        for name, hosts_n in (("valid", [pair.n_test for pair in self.pairs]),
                              ("train", [pair.n_train for pair in self.pairs])):
            chunk_counts = {math.ceil(n / self.n_batch) for n in hosts_n}
            if len(chunk_counts) != 1:
                raise UnsupportedVmapXval("folds have unequal %s eval chunk counts %s"
                                          % (name, sorted(chunk_counts)))
        self.steps_per_epoch = self.n_batches
        self.train_hosts = [pair.train.batch() for pair in self.pairs]
        self.valid_hosts = [pair.test.batch() for pair in self.pairs]

        self.fold_names = ["%d_of_%d" % (f + 1, self.folds) for f in range(self.folds)]
        trainer = getattr(settings, "trainer", None)
        if trainer is not None:
            root = trainer.tb_log_dir
            self.train_paths = [os.path.join(root, "train_%s" % n) for n in self.fold_names]
            self.valid_paths = [os.path.join(root, "valid_%s" % n) for n in self.fold_names]
            self.cache_dirs = [os.path.join(root, ".vihds_cache_%s" % n)
                               for n in self.fold_names]
            self.ckpt_dir = os.path.join(root, "checkpoints_vmap")
        else:
            self.train_paths = self.valid_paths = [None] * self.folds
            self.cache_dirs = [".vihds_cache_%s" % n for n in self.fold_names]
            self.ckpt_dir = None
        #: milliseconds of each batched optimizer step of the last ``run``
        self.step_ms = []
        self._eval_data = {}

    # ------------------------------------------------------------------ data
    def _train_data(self, device, lo=0, hi=None):
        """The train splits of folds ``lo .. hi`` (default all) on the
        device, [F * N_max, ...] fold-major (a fold smaller than N_max padded
        with its row 0, never indexed), and N_max (over every fold)."""
        n_max = max(h.observations.shape[0] for h in self.train_hosts)

        def pad(x):
            x = np.asarray(x, np.float32)
            return np.concatenate([x, np.broadcast_to(x[:1], (n_max - x.shape[0],) + x.shape[1:])])

        data = {k: torch.as_tensor(np.concatenate([pad(h[k]) for h in self.train_hosts[lo:hi]]),
                                   device=device)
                for k in ("observations", "inputs", "dev_1hot")}
        return data, n_max

    def _eval_batches(self, which, device, lo=0, hi=None):
        """The chunks of split ``which`` of folds ``lo .. hi`` (default all)
        on the device, each a batch of F * chunk rows, fold-major (a fold's
        last chunk padded with its row 0, as ``Training.evaluate`` pads it),
        and the folds' row counts.  Built once per run."""
        cached = self._eval_data.get((which, lo))
        if cached is not None:
            return cached
        hosts = (self.train_hosts if which == "train" else self.valid_hosts)[lo:hi]
        chunk = self.n_batch
        ns = [h.observations.shape[0] for h in hosts]
        n_chunks = math.ceil(max(ns) / chunk)
        times = torch.as_tensor(hosts[0].times, dtype=torch.float32, device=device)
        idx = [np.concatenate([np.arange(n), np.zeros(n_chunks * chunk - n, int)])
               .reshape(n_chunks, chunk) for n in ns]
        batches = []
        for c in range(n_chunks):
            batch = AttrDict(
                (k, torch.as_tensor(np.concatenate([np.asarray(h[k])[i[c]]
                                                    for h, i in zip(hosts, idx)]),
                                    dtype=torch.float32, device=device))
                for k in ("observations", "inputs", "dev_1hot"))
            batch["times"] = times
            batches.append(batch)
        self._eval_data[(which, lo)] = (batches, ns)
        return batches, ns

    def _evaluate(self, groups, generators, which, n_samples, alive, with_theta):
        """One pass over split ``which`` for every fold at K = ``n_samples``,
        each group of folds on its device drawing from its generator of
        ``generators``, each chunk's draws shared by the folds; a
        ``FoldLazyEval`` of the groups' outputs joined in fold order on the
        first group's device."""
        outs = []
        with torch.no_grad():
            for g, generator in zip(groups, generators):
                batches, _ = self._eval_batches(which, g.device, g.lo, g.hi)
                chunks = {}
                for batch in batches:
                    u = self.model.sample_u(generator, self.n_batch, n_samples, g.device)
                    u = u.repeat(g.hi - g.lo, 1, 1)  # the same draws for every fold
                    res = eval_step(self.model, self.program, g.params, batch, n_samples, u=u,
                                    with_theta=with_theta)
                    for k, v in res.items():
                        chunks.setdefault(k, []).append(v)
                outs.append(chunks)
        chunks = outs[0] if len(outs) == 1 else {
            k: [torch.cat([o[k][c].to(groups[0].device) for o in outs])
                for c in range(len(outs[0][k]))]
            for k in outs[0]}
        hosts = self.train_hosts if which == "train" else self.valid_hosts
        return FoldLazyEval(chunks, [h.observations.shape[0] for h in hosts], alive)

    def _fold_proxy(self, f):
        """A stand-in for fold f's ``Training``, for the plotting hooks."""
        return SimpleNamespace(settings=self.settings, program=self.program, model=self.model,
                               train_data=self.train_hosts[f], valid_data=self.valid_hosts[f])

    # ---------------------------------------------------------------- train
    def init_state(self, device, folds=None):
        """The sequential driver's init (``Training.init_state``) stacked
        over ``folds`` (default all) folds, the per-fold optimizer and the
        training generator."""
        seed = self.settings.seed or 0
        folds = folds or self.folds
        params1 = self.model.init_params(torch.Generator().manual_seed(seed), device=device)
        params_v = stack_params(params1, folds)
        for leaf in param_leaves(params_v):
            leaf.requires_grad_(True)
        opt = Optimizer(params_v, self.settings.params, self.steps_per_epoch, folds=folds)
        generator = torch.Generator(device=device).manual_seed(seed)
        return params_v, opt, generator

    def fold_groups(self, device):
        """The groups of folds and their devices: one group of every fold on
        ``device``, or one a device of the fold mesh; each with its folds
        ``lo .. hi`` and, once ``_run`` starts it, its state."""
        devices = [device] if self.fold_mesh is None else \
            [resolve_device(d) for d in self.fold_mesh.devices]
        per = self.folds // len(devices)
        return [SimpleNamespace(device=d, lo=i * per, hi=(i + 1) * per)
                for i, d in enumerate(devices)]

    def train_steps(self, params_v, opt, generator, idx, mask, data, times):
        """One batched optimizer step for each row of ``idx`` / ``mask``
        ([n_steps, F * B], fold-major, ``idx`` into ``data``).  Returns the
        per-step, per-fold ELBOs [n_steps, F] on the device, unread, and a
        time mark after each step."""
        K = self.args.train_samples
        dreg = getattr(self.args, "dreg", False)
        F = idx.shape[1] // self.n_batch
        cuda = times.device.type == "cuda"
        marks = [Training._mark(cuda)]
        elbos = []
        for s in range(idx.shape[0]):
            batch = AttrDict((k, v.index_select(0, idx[s])) for k, v in data.items())
            batch["times"] = times
            u = self.model.sample_u(generator, self.n_batch, K, times.device).repeat(F, 1, 1)
            opt.zero_grad()
            if dreg:
                loss, grads = dreg_value_and_grad(self.model, self.program, params_v, batch,
                                                  mask[s], u, folds=F)
                for part, part_grads in grads.items():
                    for leaf, g in zip(param_leaves(params_v[part]), part_grads):
                        leaf.grad = g
            else:
                loss = loss_fn(self.model, self.program, params_v, batch, mask[s], u, folds=F)
                loss.sum().backward()
            opt.step()
            elbos.append(-loss.detach())
            marks.append(Training._mark(cuda))
        return torch.stack(elbos), marks

    def _chunk_stacks(self, seed, epoch, end_epoch, alive, n_max, lo=0, hi=None, device=None):
        """The batch-index grids of folds ``lo .. hi`` (default all) for
        epochs [epoch, end_epoch] as [n_steps, F * B] index (into their
        stacked train data) and mask tensors on ``device`` (default the
        run's).  A frozen fold gathers its row 0 with mask 1 (its numbers are
        ignored)."""
        n_steps = (end_epoch - epoch + 1) * self.n_batches
        hi = self.folds if hi is None else hi
        device = self.device if device is None else device
        idx, mask = [], []
        for f in range(lo, hi):
            if alive[f]:
                st = build_epoch_stacks(seed, epoch, end_epoch, self.n_batch, self.n_batches,
                                        self.pairs[f].n_train)
            else:
                st = dict(idx=np.zeros((n_steps, self.n_batch), np.int32),
                          mask=np.ones((n_steps, self.n_batch), np.float32))
            idx.append(st["idx"].astype(np.int64) + (f - lo) * n_max)
            mask.append(st["mask"])
        return (torch.as_tensor(np.concatenate(idx, axis=1), device=device),
                torch.as_tensor(np.concatenate(mask, axis=1), device=device))

    def run(self):
        """Train every fold; returns the per-fold best-validation
        ``Results`` (None for a fold that left none)."""
        device = self.device = resolve_device(self.device)
        train_writers = [summary_writer(p) if p else None for p in self.train_paths]
        valid_writers = [summary_writer(p) if p else None for p in self.valid_paths]
        self.host_worker = HostWorker.for_run(self.settings)
        try:
            return self._run(device, train_writers, valid_writers)
        finally:
            if self.host_worker is not None:
                self.host_worker.join()
                self.host_worker = None
            for w in train_writers + valid_writers:
                if w is not None:
                    w.close()

    def _run(self, device, train_writers, valid_writers):
        args = self.args
        F = self.folds
        seed = self.settings.seed or 0
        groups = self.fold_groups(device)
        for g in groups:
            g.params, g.opt, g.generator = self.init_state(g.device, g.hi - g.lo)
        alive = [True] * F

        ckpt_every = getattr(args, "checkpoint_epoch", 0) or 0
        start_epoch = 1
        resume_from = getattr(args, "resume_from", None)
        if resume_from:
            _, state = ckpt.restore(resume_from)
            if state is not None:
                for g in groups:
                    with torch.no_grad():
                        for leaf, saved in zip(param_leaves(g.params),
                                               param_leaves(state["params"])):
                            leaf.copy_(saved[g.lo:g.hi])
                    g.opt.load_state_dict(_slice_opt_state(state["opt_state"], g.lo, g.hi))
                    g.generator.set_state(state["generator"])
                alive = [bool(a) for a in state["alive"]]
                start_epoch = int(state["epoch"]) + 1
                print("Resumed vmapped folds from %s at epoch %d"
                      % (resume_from, start_epoch - 1))

        for g in groups:
            g.data, n_max = self._train_data(g.device, g.lo, g.hi)
            g.times = torch.as_tensor(self.train_hosts[0].times, dtype=torch.float32,
                                      device=g.device)
        log_datas = [TrainingLogData() for _ in range(F)]
        empty_cache = [True] * F
        self.step_ms = []

        def next_boundary(e):
            te = args.test_epoch
            cands = [args.epochs, ((e - 1) // te + 1) * te]
            if ckpt_every:
                cands.append(((e - 1) // ckpt_every + 1) * ckpt_every)
            return min(cands)

        print("---------------------------")
        print("Training: %d folds vmapped (one batched program)" % F)
        profile_dir = getattr(args, "profile_dir", None)
        traced = False
        epoch = start_epoch
        while any(alive) and epoch < args.epochs + 1:
            start = time.time()
            end_epoch = next_boundary(epoch)
            trained = list(alive)
            # one trace, of the first chunk after the start epoch: every fold
            do_trace = bool(profile_dir) and not traced and epoch > start_epoch
            with profiling.trace(profile_dir if do_trace else None,
                                 "epochs_%d-%d" % (epoch, end_epoch)):
                for g in groups:
                    idx, mask = self._chunk_stacks(seed, epoch, end_epoch, alive, n_max, g.lo,
                                                   g.hi, g.device)
                    g.elbos, g.marks = self.train_steps(g.params, g.opt, g.generator, idx, mask,
                                                        g.data, g.times)
                # the chunk's one read
                finite = [ok for g in groups for ok in torch.isfinite(g.elbos).all(dim=0).tolist()]
            traced = traced or do_trace
            self.step_ms += elapsed_ms(groups[0].marks)
            for f in range(F):
                if alive[f] and not finite[f]:
                    print("Fold %d: ELBO = nan, freezing this fold." % (f + 1))
                    alive[f] = False
            epoch = end_epoch
            # one batched run trained every live fold: each is charged its
            # share, so the counters stay comparable to the sequential driver's
            per_fold = (time.time() - start) / max(1, sum(trained))
            for f in range(F):
                if trained[f]:
                    log_datas[f].total_train_time += per_fold
            if epoch % args.test_epoch == 0 and any(alive):
                self._eval_boundary(groups, epoch, log_datas, train_writers, valid_writers,
                                    empty_cache, alive)
            if ckpt_every and self.ckpt_dir and epoch % ckpt_every == 0:
                # alive already holds this chunk's freezes: a resumed run
                # keeps a frozen fold frozen
                ckpt.save(self.ckpt_dir, epoch, {
                    "params": self._stacked_params(groups),
                    "opt_state": groups[0].opt.state_dict() if len(groups) == 1 else
                    _cat_opt_states([g.opt.state_dict() for g in groups], device),
                    "generator": groups[0].generator.get_state(),
                    "epoch": epoch,
                    "alive": torch.tensor(alive),
                })
            epoch += 1

        self.final_params = self._stacked_params(groups)
        self.log_datas = log_datas
        results = []
        for f in range(F):
            if empty_cache[f]:
                print("Fold %d: no results in cache" % (f + 1))
                results.append(None)
                continue
            out = Results()
            out.load(self.cache_dirs[f])
            out.elbo_list = log_datas[f].validation_elbo_list
            results.append(out)
        return results

    @staticmethod
    def _stacked_params(groups):
        """Every fold's params, [F, ...] leaves in fold order on the first
        group's device."""
        if len(groups) == 1:
            return groups[0].params
        return _map_params(lambda *leaves: torch.cat([leaf.detach().to(groups[0].device)
                                                      for leaf in leaves]),
                           *(g.params for g in groups))

    def _eval_boundary(self, groups, epoch, log_datas, train_writers, valid_writers,
                       empty_cache, alive):
        """The big-K evaluation of every fold at a ``test_epoch`` boundary:
        each split in one pass for all folds (the sequential driver's
        generator of (seed, epoch), the train split first), then, fold by
        fold, the summaries, the best-validation cache, the figures (on the
        host worker) and the JAX package's ``epoch N | fold F | ...`` line."""
        args = self.args
        F = self.folds
        t0 = time.time()
        plot_epoch = getattr(args, "plot_epoch", 0) or 0
        plot = plot_epoch > 0 and epoch % plot_epoch == 0
        want_theta_plot = bool(getattr(self.settings.params, "theta_columns", None)) and plot
        seed = self.settings.seed or 0
        # the sequential driver's generator of (seed, epoch), one a group
        gens = [torch.Generator(device=g.device).manual_seed((seed * 1_000_003 + epoch) % (2 ** 62))
                for g in groups]
        train_ev = self._evaluate(groups, gens, "train", args.train_samples, alive,
                                  with_theta=want_theta_plot)
        valid_ev = self._evaluate(groups, gens, "valid", args.test_samples, alive,
                                  with_theta=True)
        train_ev.want_scalars()
        valid_ev.want_scalars()
        have_writers = any(w is not None for w in train_writers + valid_writers)
        if have_writers:
            train_ev.want_summaries()
            valid_ev.want_summaries()
        improved = [alive[f] and valid_ev.merged[f].elbo > log_datas[f].max_val_elbo
                    for f in range(F)]
        if any(improved) or (have_writers and plot):
            valid_ev.want_results()
            if have_writers and plot:
                train_ev.want_results()
        # the batched pass served every live fold: each is charged its share
        share = (time.time() - t0) / max(1, sum(alive))
        dynamic = self.model.ode_model.precisions.dynamic
        for f in range(F):
            if not alive[f]:
                continue
            fold_t0 = time.time()
            log_data = log_datas[f]
            log_data.n_test += 1
            train_merged, valid_merged = train_ev.merged[f], valid_ev.merged[f]
            update_summaries(train_writers[f], epoch, train_merged, self.program, self.settings)
            update_summaries(valid_writers[f], epoch, valid_merged, self.program, self.settings)
            if improved[f]:
                log_data.max_val_elbo = valid_merged.elbo
                make_results(self.model, self.program, valid_merged).dump(self.cache_dirs[f])
                empty_cache[f] = False
            if plot and (train_writers[f] is not None or valid_writers[f] is not None):
                proxy = self._fold_proxy(f)
                outputs = [(w, host, make_results(self.model, self.program, merged))
                           for w, host, merged in (
                               (train_writers[f], self.train_hosts[f], train_merged),
                               (valid_writers[f], self.valid_hosts[f], valid_merged))
                           if w is not None]

                def figures(proxy=proxy, outputs=outputs, writer=valid_writers[f],
                            merged=train_merged):
                    for w, host, output in outputs:
                        plotting_hooks.eval_plots(proxy, w, epoch, host, output,
                                                  dynamic=dynamic)
                    if want_theta_plot:
                        plotting_hooks.weighted_theta_plot(proxy, writer, epoch, merged)

                run_on(self.host_worker, figures)
            log_data.training_elbo_list.append(train_merged.elbo)
            log_data.validation_elbo_list.append(valid_merged.elbo)
            log_data.total_test_time += share + (time.time() - fold_t0)
            print("epoch %4d | fold %d | train (iwae-elbo = %0.4f) | val (iwae-elbo = %0.4f)"
                  % (epoch, f + 1, train_merged.elbo, valid_merged.elbo))


def detect_outlier_folds(elbos, nats):
    """Indices of folds whose best-validation ELBO lands more than ``nats``
    below the median of their sibling folds (or that left no result)."""
    vals = np.array([v if v is not None and np.isfinite(v) else np.nan for v in elbos], float)
    out = []
    for f in range(len(vals)):
        sibs = vals[np.arange(len(vals)) != f]
        sibs = sibs[np.isfinite(sibs)]
        if len(sibs) == 0:
            continue
        if not np.isfinite(vals[f]) or vals[f] < np.median(sibs) - nats:
            out.append(f)
    return out


def _handle_outlier_folds(args, settings, runner, results, device):
    """Report folds that landed far below their siblings; with
    ``--rerun_outliers`` retrain each through the sequential driver under
    the training seed ``seed + 10007 + f`` (the data split unchanged) and
    keep the better best-validation result, re-dumping the winner into the
    fold's cache (the JAX package's messages)."""
    from vihds_tpu_torch.run_xval import run_on_split

    nats = float(getattr(args, "outlier_nats", 0) or 50.0)
    elbos = [None if r is None else float(r.elbo) for r in results]
    outliers = detect_outlier_folds(elbos, nats)
    if not outliers:
        finite = [e for e in elbos if e is not None and np.isfinite(e)]
        spread = " (best-val spread %.1f .. %.1f)" % (min(finite), max(finite)) if finite else ""
        print("Outlier-fold check: all %d folds within %.0f nats of the sibling median%s"
              % (len(results), nats, spread))
        return results
    med = np.median([e for e in elbos if e is not None and np.isfinite(e)])
    print("================================================================")
    print("WARNING: %d of %d folds landed > %.0f nats below the sibling "
          "median (%.1f) — likely slow-basin optima (see BASELINE.md "
          "'Long-horizon equivalence'):" % (len(outliers), len(results), nats, med))
    for f in outliers:
        print("  fold %d: best-val %s" % (
            f + 1, "none (no cached result)" if elbos[f] is None else "%.1f" % elbos[f]))
    if not getattr(args, "rerun_outliers", False):
        print("Pass --rerun_outliers to retrain just these folds sequentially "
              "under a fresh training RNG and keep the better result.")
        return results
    for f in outliers:
        rerun_seed = (settings.seed or 0) + 10007 + f
        print("---------------------------")
        print("Rerunning fold %d sequentially with training seed %d "
              "(data split unchanged)" % (f + 1, rerun_seed))
        a = copy.copy(args)
        a.heldout = None
        s = copy.copy(settings)
        s.seed = rerun_seed  # training RNG only; the fold split rides args.seed
        _, rerun, _ = run_on_split(a, s, split=f + 1, device=device)
        new = None if rerun is None else float(rerun.elbo)
        old = elbos[f]
        if new is not None and (old is None or new > old):
            print("Fold %d recovered: best-val %.1f (was %s)" % (
                f + 1, new, "none" if old is None else "%.1f" % old))
            results[f] = rerun
        else:
            print("Fold %d rerun did not improve (%s vs %s); keeping the original"
                  % (f + 1, new, old))
        # the rerun shares the fold's cache: re-dump the winner, which the
        # merge reads
        if results[f] is not None:
            results[f].dump(runner.cache_dirs[f])
    return results


def run_all_folds(args, settings, device="cuda"):
    """``call_run_xval``'s batched branch: [(split, data pair, best-val
    Results or None)] for every fold, or None (with the printed reason) where
    this configuration needs the sequential driver.  With ``--mesh auto``
    the folds spread over the local cards (``make_fold_mesh``); the JAX
    package's decisions and lines, word for word."""
    reason = unsupported_reason(args, settings)
    if reason is not None:
        print("vmap_folds: falling back to sequential folds (%s)" % reason)
        return None
    check_fixed_grid(settings)
    if getattr(args, "mesh_data", None) or getattr(args, "mesh_sample", None):
        # an explicit (data, sample) factorisation is a request the fold
        # mesh cannot honour: the sequential driver shards each fold over it
        print(
            "vmap_folds: falling back to sequential folds "
            "(explicit --mesh_data/--mesh_sample: each fold shards over the "
            "requested (data, sample) mesh)"
        )
        return None
    fold_mesh = None
    if getattr(args, "mesh", "off") != "off":
        devices = local_devices(resolve_device(device))
        fold_mesh = make_fold_mesh(args.folds, devices)
        if fold_mesh is None:
            if len(devices) > 1:
                print(
                    "vmap_folds: falling back to sequential folds "
                    "(no device count > 1 divides folds=%d; sequential folds "
                    "shard over the (data, sample) mesh)" % args.folds
                )
                return None
            # one device: the batched program still saves the folds' launches
            print("vmap_folds: single device; running the batched program unsharded")
        else:
            print("Fold mesh: %d folds sharded over %d devices"
                  % (args.folds, fold_mesh.shape["fold"]))
    try:
        runner = VmapXval(args, settings, device=device, fold_mesh=fold_mesh)
    except UnsupportedVmapXval as e:
        print("vmap_folds: falling back to sequential folds (%s)" % e)
        return None
    results = runner.run()
    results = _handle_outlier_folds(args, settings, runner, results, device)
    return [(f + 1, runner.pairs[f], results[f]) for f in range(args.folds)]
