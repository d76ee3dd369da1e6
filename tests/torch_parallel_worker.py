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


if __name__ == "__main__":
    _step(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6]))
