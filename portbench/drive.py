"""The system under test, driven through a cell's traffic: the port's
fold-batched cross-validation driver (``vihds_tpu_torch.xfold.VmapXval``).

A traffic file sets the mix: ``mode`` ``train`` (batched optimizer steps,
in chunks of ``chunk_epochs`` epochs that each end in the driver's one
``isfinite`` read of the chunk's ELBOs, as ``VmapXval._run`` chunks them)
or ``eval`` (one client in a closed loop: each request is one pass of
``VmapXval._evaluate`` over the held-out split of every fold at K =
``samples``, then the reads of an evaluation boundary, ``want_scalars``
and ``want_results``, after ``warm_passes`` passes of set-up); ``folds``;
``samples``; the traced segment's size (``trace_epochs`` /
``trace_passes``); and, for the check, ``check_first_passes`` (the pass
compared besides the last is the seed's residue modulo it).

The benchmark hands the program its inputs: the weights, made from the seed
by the reference's ``make_params`` and copied into every fold, and the
generator the draws come from, seeded from the seed.  The data are the
configuration's CSVs, which the program and the reference each read.
"""

import os
import tempfile
import time
from types import SimpleNamespace

import torch

from portbench import trace as tracemod

#: the seed of the evaluation draws is the run's seed plus this
EVAL_DRAWS = 7919


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(a, b):
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else 1e3 * (b - a)


def walk(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in walk(v, prefix + (k,))]
    return [(prefix, tree)]


class Program:
    """The port's batched driver over ``folds`` folds of a spec, with its
    stacked params, optimizer and training data on ``device``."""

    def __init__(self, spec, mix, seed, device):
        import yaml

        from vihds_tpu_torch.config import Config
        from vihds_tpu_torch.xfold import VmapXval

        args = SimpleNamespace(
            seed=seed, folds=mix["folds"], split=1, heldout=None,
            train_samples=mix["samples"], test_samples=mix["samples"], epochs=10 ** 6,
            test_epoch=mix.get("chunk_epochs", 1), plot_epoch=0, dreg=False, checkpoint_epoch=0,
            profile_dir=None, mesh="off")
        with tempfile.TemporaryDirectory() as tmp:
            args.yaml = os.path.join(tmp, "spec.yaml")
            with open(args.yaml, "w") as f:
                yaml.safe_dump(spec, f, sort_keys=False)
            settings = Config(args)
        self.device = device
        self.runner = VmapXval(args, settings, device=str(device))
        self.folds = mix["folds"]
        self.group = self.runner.fold_groups(device)[0]
        self.params, self.opt, _ = self.runner.init_state(device, self.folds)
        self.group.params = self.params

    def load_weights(self, weights):
        """Copy ``weights`` (one fold's tree) into every fold's params."""
        ours = dict(walk(weights))
        theirs = walk(self.params)
        if sorted(p for p, _ in theirs) != sorted(ours):
            raise ValueError("the program's params %s are not the benchmark's weights %s"
                             % (sorted(p for p, _ in theirs), sorted(ours)))
        with torch.no_grad():
            for path, leaf in theirs:
                leaf.copy_(ours[path].expand_as(leaf))

    def snapshot(self):
        return {p: leaf.detach().clone() for p, leaf in walk(self.params)}

    def moments(self):
        """Adam's first and second moments ({path: [F, ...]}; zeros for a
        leaf the optimizer holds none of)."""
        state = self.opt.adam.state
        return [{p: state[leaf][key].detach().clone() if leaf in state
                 else torch.zeros_like(leaf) for p, leaf in walk(self.params)}
                for key in ("exp_avg", "exp_avg_sq")]

    def first_moments(self):
        """The gradient of the one step taken so far, from Adam's first
        moment ((1 - beta1) g after one step)."""
        return {p: m / 0.1 for p, m in self.moments()[0].items()}


class Train:
    """Batched training steps of every fold."""

    def __init__(self, prog, mix, seed):
        self.prog, self.mix, self.seed = prog, mix, seed
        r = prog.runner
        self.alive = [True] * prog.folds
        self.data, self.n_max = r._train_data(prog.device)
        self.times = torch.as_tensor(r.train_hosts[0].times, dtype=torch.float32,
                                     device=prog.device)
        self.gen = torch.Generator(device=prog.device).manual_seed(seed)
        self.epoch = 1
        self.rows = prog.folds * r.n_batch * mix["samples"]
        self.check = {}

    def _chunk(self, epochs):
        r = self.prog.runner
        idx, mask = r._chunk_stacks(self.seed, self.epoch, self.epoch + epochs - 1, self.alive,
                                    self.n_max)
        self.epoch += epochs
        return idx, mask

    def _steps(self, idx, mask):
        p = self.prog
        return p.runner.train_steps(p.params, p.opt, self.gen, idx, mask, self.data, self.times)

    def setup(self):
        """The first epoch: its first step, then steps 2-3 (what the check
        compares), then the rest of it, which warms every shape."""
        idx, mask = self._chunk(1)
        self.check["gen0"] = self.gen.get_state()
        self.check["p0"] = self.prog.snapshot()
        e1, _ = self._steps(idx[:1], mask[:1])
        self.check["grad1"] = self.prog.first_moments()
        e2, _ = self._steps(idx[1:3], mask[1:3])
        self.check["p3"] = self.prog.snapshot()
        self.check["losses"] = (-torch.cat([e1, e2])).double().cpu()
        e3, _ = self._steps(idx[3:], mask[3:])
        torch.isfinite(e3).all(dim=0).tolist()

    def window(self, seconds, clock):
        """Chunks until ``seconds`` have passed; the window ends at the last
        chunk's read.  What the program holds as the window starts (params,
        Adam's moments and count, the draws' generator) and the first
        chunk's first three losses go to the check."""
        p = self.prog
        m, v = p.moments()
        start = dict(epoch=self.epoch, gen=self.gen.get_state(), params=p.snapshot(), m=m, v=v,
                     t=p.opt.count)
        out = SimpleNamespace(chunk_enqueue_s=[], chunk_steps=[], step_ms=[], steps=0, failed=0)
        first = None
        t0 = clock()
        while True:
            idx, mask = self._chunk(self.mix["chunk_epochs"])
            ta = clock()
            elbos, marks = self._steps(idx, mask)
            tb = clock()
            first = elbos if first is None else first
            finite = torch.isfinite(elbos).all(dim=1).tolist()
            t1 = clock()
            out.chunk_enqueue_s.append(tb - ta)
            out.chunk_steps.append(len(finite))
            out.step_ms += [_ms(a, b) for a, b in zip(marks, marks[1:])]
            out.steps += len(finite)
            out.failed += finite.count(False)
            if t1 - t0 >= seconds:
                break
        out.window_s = t1 - t0
        out.units, out.rows_per_unit = out.steps, self.rows
        self.check["window"] = dict(start, losses=(-first[:3]).double().cpu())
        return out

    def traced(self):
        idx, mask = self._chunk(self.mix["trace_epochs"])
        elbos, _ = self._steps(idx, mask)
        torch.isfinite(elbos).all(dim=0).tolist()
        return idx.shape[0]


class Eval:
    """Closed-loop evaluation passes over the held-out splits."""

    def __init__(self, prog, mix, seed):
        self.prog, self.mix, self.seed = prog, mix, seed
        self.alive = [True] * prog.folds
        self.gen = torch.Generator(device=prog.device).manual_seed(seed + EVAL_DRAWS)
        r = prog.runner
        self.n_series = sum(h.observations.shape[0] for h in r.valid_hosts)
        self.rows = self.n_series * mix["samples"]
        # which window pass the check compares besides the last
        self.sampled = seed % mix["check_first_passes"]
        self.check = {"passes": []}

    def one(self):
        """One request: (draws' generator state, enqueue seconds, the
        ``FoldLazyEval`` with its scalars and results read)."""
        p = self.prog
        state = self.gen.get_state()
        ta = time.perf_counter()
        ev = p.runner._evaluate([p.group], [self.gen], "valid", self.mix["samples"], self.alive,
                                with_theta=True)
        tb = time.perf_counter()
        ev.want_scalars()
        ev.want_results()
        return state, tb - ta, ev

    def setup(self):
        for _ in range(self.mix["warm_passes"]):
            self.one()
        _sync(self.prog.device)

    def window(self, seconds, clock):
        """Passes until ``seconds`` have passed; each pass's wall runs from
        its call to its results on the host."""
        out = SimpleNamespace(pass_enqueue_s=[], pass_ms=[], passes=0, failed=0)
        last = None
        t0 = clock()
        while True:
            ta = clock()
            state, enq, ev = self.one()
            t1 = clock()
            out.pass_ms.append(1e3 * (t1 - ta))
            out.pass_enqueue_s.append(enq)
            if out.passes == self.sampled:
                self.check["passes"].append((state, ev))
            last = (out.passes, state, ev)
            out.passes += 1
            out.failed += not all(torch.isfinite(torch.as_tensor(m["per_item_elbo"])).all()
                                  for m in ev.merged)
            if t1 - t0 >= seconds:
                break
        if last[0] != self.sampled:
            self.check["passes"].append(last[1:])
        out.window_s = t1 - t0
        out.units, out.rows_per_unit = out.passes, self.rows
        return out

    def traced(self):
        for _ in range(self.mix["trace_passes"]):
            self.one()
        return self.mix["trace_passes"]


MODES = {"train": Train, "eval": Eval}


def _profiled(driver, device, activities, path):
    """The driver's traced segment under ``torch.profiler`` with
    ``activities``, bracketed by two one-element device-to-device copies so
    that the first and the last device operation mark the segment's ends;
    returns the units it ran and writes the Chrome trace to ``path``."""
    marks = torch.zeros(2, device=device)
    _sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(tracemod.WINDOW):
            marks[1:].copy_(marks[:1])
            units = driver.traced()
            _sync(device)
            marks[:1].copy_(marks[1:])
            _sync(device)
    prof.export_chrome_trace(path)
    return units


def traced_segment(driver, device, tmp):
    """Two traced segments of the driver: one with the device's activity
    alone (its busy time, kernels and window: the profiler's per-operator
    host callbacks would slow the host and inflate the idle share) and one
    with the host's operators too, which names the idle gaps.  Returns
    (units run in the first, its Trace, the second's Trace, the kernel
    launches the program counted over the first)."""
    from vihds_tpu_torch.ops import fused_blackbox, fused_ode

    act = torch.profiler.ProfilerActivity
    device_acts = [act.CUDA] if device.type == "cuda" else [act.CPU]
    counters = dict(fused_ode.COUNTERS, **fused_blackbox.COUNTERS)
    before = {k: fn.launches for k, fn in counters.items()}
    path = os.path.join(tmp, "device.json")
    units = _profiled(driver, device, device_acts, path)
    launches = {k: fn.launches - before[k] for k, fn in counters.items()
                if fn.launches != before[k]}
    device_trace = tracemod.load(path)
    path = os.path.join(tmp, "host.json")
    _profiled(driver, device, [act.CPU] + device_acts[:device.type == "cuda"], path)
    return units, device_trace, tracemod.load(path), launches
