"""Rank processes for the port's multi-process tests (not a pytest module).

``launch`` starts N copies of a Python snippet, one per rank, each told its
rank, the world size and a free port, and kills every one of them when the
wall limit passes (a hung rank fails its test instead of holding the suite).
The snippets import the port alone: no JAX, no ``tests.conftest``.

Run as a script, it is one rank of the sharded-step check::

    python tests/torch_parallel_worker.py IN.npz OUT_DIR RANK WORLD PORT

It joins a gloo process group of WORLD ranks, reads the spec, params (keys
``p['enc']...``), the batch, the masks and the draws of each case from
IN.npz, and for every case whose mesh has WORLD ranks runs one training
step (``training.loss_fn`` and its backward, or ``dreg_value_and_grad``)
under ``parallel.shard_step``: its decoder block on this rank's rows and
samples; it writes the loss and each gradient leaf (keys
``<case>/g['enc']...``) to OUT_DIR/rank<RANK>.npz.

As ``python tests/torch_parallel_worker.py refine IN.json OUT_DIR RANK WORLD
PORT PORT2`` it is one rank of the samplers' and serving's check: it runs
``predict.main`` with IN.json's argument list and ``--distributed
127.0.0.1:PORT,WORLD,RANK``, then joins a second process group at PORT2
and runs the five samplers (``run_samplers``), and ``ADAPTIVE_SAMPLERS``
under ``solver: dopri5``, under each of IN.json's meshes of
WORLD ranks, and writes their outputs (keys
``<mesh>/<sampler>/<output>``, ``<mesh>/dopri5/<sampler>/<output>``) to
OUT_DIR/rank<RANK>.npz.  With WORLD 1 it
is the one-process reference: IN.json's other ``predict`` argument list,
the samplers without a mesh (keys ``<sampler>/<output>``), OUT_DIR/one.npz;
a process of its own, as the ranks run (a process that imports JAX, as a
test's does, rounds some of the encoder's sums otherwise).
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a rank's collective waits for the others
RANK_TIMEOUT = 60


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(boot, extra=None):
    """The environment of a rank: the repo importable, one thread, the
    collectives' timeout, and tensorflow kept out of tensorboard's import by
    a ``sitecustomize`` written into the directory ``boot`` (the event files
    come from tensorboard's own writer, as where tensorflow is not
    installed; its import takes ~12 s a process)."""
    os.makedirs(boot, exist_ok=True)
    with open(os.path.join(boot, "sitecustomize.py"), "w") as f:
        f.write("import sys\nsys.modules['tensorflow'] = None\n")
    env = dict(os.environ)
    env.update(PYTHONPATH=os.pathsep.join([boot, REPO]), OMP_NUM_THREADS="1",
               VIHDS_DIST_TIMEOUT=str(RANK_TIMEOUT))
    env.pop("VIHDS_DISTRIBUTED", None)
    env.update(extra or {})
    return env


def launch(argvs, wall, env, cwd=REPO):
    """Run one process per argument list of ``argvs`` (after the Python
    interpreter) side by side; returns their (stdout, stderr), in order,
    once all have exited 0.  Past ``wall`` seconds every process is killed
    and the call raises."""
    import time

    procs = [subprocess.Popen([sys.executable] + argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=cwd) for argv in argvs]
    deadline = time.monotonic() + wall
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, "rank exited %s:\n%s\n%s" % (p.returncode, out[-3000:],
                                                               err[-3000:])
    return outs


def cli_argvs(module, argv, n_ranks, device="cpu"):
    """``argvs`` for ``launch``: ``module``'s ``main(argv + --distributed
    127.0.0.1:PORT,N,r)`` on each of ``n_ranks`` ranks (one process and no
    ``--distributed`` where ``n_ranks`` is 0)."""
    code = ("import sys; from vihds_tpu_torch import %s as m; m.main(sys.argv[1:], device=%r)"
            % (module, device))
    if n_ranks == 0:
        return [["-c", code] + list(argv)]
    port = free_port()
    return [["-c", code] + list(argv) + ["--distributed", "127.0.0.1:%d,%d,%d" % (port, n_ranks, r)]
            for r in range(n_ranks)]


def _step(path_in, out_dir, rank, world, port):
    import numpy as np
    import torch

    from vihds_tpu_torch import parallel
    from vihds_tpu_torch import training as T
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.convert import keystr_leaves, params_from_keystr
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.parallel import multihost
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.run_xval import create_parser
    from vihds_tpu_torch.utils.attrdict import AttrDict
    from vihds_tpu_torch.vae import VAE

    n, r, device = multihost.initialize("tcp://127.0.0.1:%d" % port, world, rank, device="cpu",
                                        timeout=RANK_TIMEOUT)
    assert (n, r) == (world, rank)
    inp = np.load(path_in)
    cases = json.loads(str(inp["cases"]))
    out = {}
    for case in cases:
        n_data, n_sample = case["mesh"]
        if n_data * n_sample != world:
            continue
        args = create_parser(True).parse_args([str(inp["spec"])])
        settings = Config(args)
        settings.params.solver = case["solver"]
        data = build_datasets(args, settings)
        program = ParamProgram(parse_parameters(settings.params))
        model = VAE(settings, data, program)
        # the model's own tree (an empty part, e.g. a decoder without
        # leaves, has no key in the file), its leaves from the file
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
        _fill(params, params_from_keystr(inp, prefix="p", device="cpu"))
        for leaf in T.param_leaves(params):
            leaf.requires_grad_(True)
        u = torch.as_tensor(inp[case["u"]])
        B = u.shape[0]
        batch = AttrDict((k, torch.as_tensor(inp["batch_" + k][:B]))
                         for k in ("observations", "inputs", "dev_1hot"))
        batch["times"] = torch.as_tensor(inp["batch_times"])
        mask = torch.as_tensor(inp[case["mask"]])
        mesh = parallel.make_mesh(n_data, n_sample, device=device)
        loss = parallel.shard_step(_grad_step, mesh)(model, program, params, batch, mask, u,
                                                     case["dreg"])
        out[case["name"] + "/loss"] = np.asarray(float(loss))
        for key, g in keystr_leaves(_grad_tree(params), "g").items():
            out[case["name"] + "/" + key] = g
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    multihost.shutdown()


def _grad_step(model, program, params, batch, mask, u, dreg):
    """-ELBO of one step, its gradients left on the params' ``.grad``."""
    from vihds_tpu_torch import training as T

    if dreg:
        loss, grads = T.dreg_value_and_grad(model, program, params, batch, mask, u)
        for part, part_grads in grads.items():
            for leaf, g in zip(T.param_leaves(params[part]), part_grads):
                leaf.grad = g
        return loss
    loss = T.loss_fn(model, program, params, batch, mask, u)
    loss.backward()
    return loss.detach()


def _fill(params, loaded):
    for k, v in params.items():
        if isinstance(v, dict):
            _fill(v, loaded.get(k, {}))
        else:
            params[k] = loaded[k]


def _grad_tree(params):
    import torch

    if isinstance(params, dict):
        return {k: _grad_tree(v) for k, v in params.items()}
    return params.grad if params.grad is not None else torch.zeros_like(params)


#: the samplers of ``run_samplers`` at a tiny depth: 4 chains, 3 steps
SAMPLERS = {
    "hmc_refine": dict(n_chains=4, n_steps=3, n_leapfrog=2),
    "hmc_refine_pooled": dict(n_chains=4, n_steps=3, n_leapfrog=2),
    "gibbs_refine_pooled": dict(n_chains=4, n_sweeps=3, n_leapfrog=2),
    "pm_refine_shared": dict(n_chains=4, n_steps=3, n_particles=4),
    "smc_refine": dict(n_particles=4, n_temps=3, n_moves=1, n_leapfrog=2),
}
#: the samplers of ``run_samplers`` under ``solver: dopri5``, (their
#: arguments, the time points their batch keeps: None, all): the
#: pseudo-marginal sampler, whose every decision reads the gathered
#: likelihood of an adaptive forward, and HMC, whose gradients also take
#: the adjoint's backward, on the series' first 20 time points (the
#: encoder reads all of them) to keep the CPU run short.  4 rows a series
#: (chains x particles): the CPU's elementwise kernels round a tensor's
#: elements past its last 32-element chunk with the scalar function, so a
#: right-hand side's [B, K] columns give one process and a rank's block the
#: same bits only where both lie within the scalar tail (12 and 6 or 8
#: elements here; each element's arithmetic on the card does not depend on
#: its place)
ADAPTIVE_SAMPLERS = {
    "pm_refine_shared": (dict(n_chains=2, n_steps=3, n_particles=2), None),
    "hmc_refine": (dict(n_chains=4, n_steps=2, n_leapfrog=1), 20),
}


def sampler_setup(spec_path, n_series, device="cpu", solver="pallas_midpoint", n_times=None):
    """(model, program, params, batch) of the samplers' check: the spec
    under ``solver`` (default ``pallas_midpoint``), params from seed 0, its
    first ``n_series`` training series (with ``n_times``, their first
    ``n_times`` time points, the encoder reading every one)."""
    import numpy as np
    import torch

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.run_xval import create_parser
    from vihds_tpu_torch.training import batch_tensors
    from vihds_tpu_torch.vae import VAE

    args = create_parser(True).parse_args([spec_path, "--seed", "0"])
    settings = Config(args)
    settings.params.solver = solver
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(torch.Generator().manual_seed(0), device=device)
    host = data.train.dataset.select(np.arange(n_series))
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(host, np.arange(n_series), times, device)
    if n_times is not None:
        batch["enc_observations"] = batch.observations
        batch["observations"] = batch.observations[..., :n_times]
        batch["times"] = times[:n_times]
    return model, program, params, batch


def run_samplers(model, program, params, batch, seed=3, samplers=SAMPLERS):
    """Each sampler of ``samplers`` ({name: arguments}, default
    ``SAMPLERS``) from ``seed``: {sampler: {output: numpy array}} (nested
    outputs flattened with '.')."""
    from vihds_tpu_torch import refine

    def flat(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + k + ".", out)
            elif hasattr(v, "cpu"):
                out[prefix + k] = v.detach().cpu().numpy()
        return out

    return {name: flat(getattr(refine, name)(model, program, params, batch, seed, **kw), "", {})
            for name, kw in samplers.items()}


def _sampler_runs(cfg):
    """{key: numpy array} of every sampler of ``SAMPLERS`` and of
    ``ADAPTIVE_SAMPLERS`` (keys ``dopri5/<sampler>/<output>``), run under the
    ambient mesh, if any."""
    got = run_samplers(*sampler_setup(cfg["spec"], cfg["series"]))
    for name, (kw, n_times) in ADAPTIVE_SAMPLERS.items():
        setup = sampler_setup(cfg["spec"], cfg["series"], solver="dopri5", n_times=n_times)
        got["dopri5/" + name] = run_samplers(*setup, samplers={name: kw})[name]
    return {"%s/%s" % (name, key): v for name, arrays in got.items()
            for key, v in arrays.items()}


def _refine(path_in, out_dir, rank, world, port, port2):
    import numpy as np

    from vihds_tpu_torch import parallel, predict
    from vihds_tpu_torch.parallel import multihost

    with open(path_in) as f:
        cfg = json.load(f)
    if world == 1:
        predict.main(cfg["predict_one"], device="cpu")
        np.savez(os.path.join(out_dir, "one.npz"), **_sampler_runs(cfg))
        return
    predict.main(cfg["predict"] + ["--distributed", "127.0.0.1:%d,%d,%d" % (port, world, rank)],
                 device="cpu")
    n, r, device = multihost.initialize("tcp://127.0.0.1:%d" % port2, world, rank, device="cpu",
                                        timeout=RANK_TIMEOUT)
    assert (n, r) == (world, rank)
    out = {}
    for n_data, n_sample in cfg["meshes"]:
        mesh = parallel.make_mesh(n_data, n_sample, device=device)
        with parallel.use_mesh(mesh):
            got = _sampler_runs(cfg)
        out.update({"%d%d/%s" % (n_data, n_sample, key): v for key, v in got.items()})
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    multihost.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "refine":
        _refine(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:8]))
    else:
        _step(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6]))
