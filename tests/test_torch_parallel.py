"""The port's sharded training step (``vihds_tpu_torch.parallel``: the
decoder block over the ranks, ``VAE.forward_sharded``) over gloo ranks on
the CPU.

Ranks run ``tests/torch_parallel_worker.py`` (the port alone); the inputs go
to them, and their losses and gradients come back, through ``.npz`` files.
On ``dr_constant_one``, the JAX package's params (carried across by
``convert``) and its draws ``u`` (from its keys):

* against the JAX package's sharded step on the 8 virtual CPU devices (as
  ``tests/test_parallel.py`` runs it, u constrained to P('data', 'sample')),
  at meshes (2, 1), (1, 2) and (2, 2), on the trajectory route (the port's
  fused kernels' plain versions, ``solver: pallas_midpoint``; the JAX
  package's generic midpoint solver) and on the fold route: the loss to rtol
  1e-5, each gradient leaf to 1e-4 of its largest entry;
* against the port's unsharded step on the same inputs, at a batch and
  sample count that no mesh axis divides (B = 5, K = 7, the last row
  masked), one case with ``--dreg`` and one under ``solver: dopri5`` (the
  step controller's norm over the whole batch on every rank): the loss to
  rtol 1e-6, each leaf to 1e-5 of its largest entry.  A gradient counted
  once a rank too many would be 2x or 4x;
* every rank holds the same loss and gradients, bit for bit (the lockstep
  every host decision relies on).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import make_args, spec
from tests.torch_parallel_worker import REPO, launch, free_port, rank_env

JAX_CASES = [("%s_%d%d" % (route, d, s), route, (d, s))
             for route in ("trajectory", "fold") for d, s in ((2, 1), (1, 2), (2, 2))]
#: (name, route, mesh, dreg) of the uneven cases held against the port alone
UNEVEN_CASES = [("uneven_trajectory_22", "trajectory", (2, 2), False),
                ("uneven_fold_21", "fold", (2, 1), False),
                ("uneven_fold_12", "fold", (1, 2), False),
                ("dreg_fold_22", "fold", (2, 2), True),
                ("dreg_trajectory_12", "trajectory", (1, 2), True),
                ("adaptive_12", "adaptive", (1, 2), False)]
SOLVER = {"trajectory": "pallas_midpoint", "fold": "midpoint", "adaptive": "dopri5"}
EVEN, UNEVEN = (4, 8), (5, 7)
WALL = 180


def _jax_reference(jmodel, jprog, jparams, jbatch, u, mask, route, shape):
    """The JAX package's sharded value and gradient on the first D x S of
    the 8 virtual devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vihds_tpu import parallel as jparallel
    from vihds_tpu.training import iwae_elbo, iwae_elbo_terms
    from vihds_tpu.utils.attrdict import AttrDict

    mesh = jparallel.make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])

    def neg_elbo(params, batch, u, mask):
        u = jparallel.constrain_u(u, mesh)
        if route == "fold":
            out = jmodel.forward_logprob(params, batch, u)
            terms = AttrDict(log_w=out.log_p_by_species.sum(axis=2)
                             + jprog.log_prob(jprog.prior_q(), out.theta)
                             - jprog.log_prob(out.q, out.theta))
        else:
            out = jmodel.forward(params, batch, u)
            terms = iwae_elbo_terms(jprog, out, batch, jmodel.use_laplace)
        return -iwae_elbo(terms, mask)

    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step = jax.jit(jax.value_and_grad(neg_elbo),
                   in_shardings=(repl, jparallel.batch_shardings(mesh), repl, rows))
    value, grads = step(jparams, jbatch, u, mask)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _port_unsharded(params_np, batch_np, u, mask, route, dreg):
    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch import training as T
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.convert import params_from_jax
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    args = run_xval.create_parser(True).parse_args([spec("dr_constant_one.yaml")])
    settings = Config(args)
    settings.params.solver = SOLVER[route]
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, build_datasets(args, settings), program)
    params = params_from_jax(params_np, device="cpu")
    for leaf in T.param_leaves(params):
        leaf.requires_grad_(True)
    B = u.shape[0]
    batch = T.AttrDict((k, torch.as_tensor(v[:B])) for k, v in batch_np.items() if k != "times")
    batch["times"] = torch.as_tensor(batch_np["times"])
    u, mask = torch.as_tensor(u), torch.as_tensor(mask)
    if dreg:
        loss, grads = T.dreg_value_and_grad(model, program, params, batch, mask, u)
        for part, part_grads in grads.items():
            for leaf, g in zip(T.param_leaves(params[part]), part_grads):
                leaf.grad = g
    else:
        loss = T.loss_fn(model, program, params, batch, mask, u)
        loss.backward()
    return float(loss), _grads(params)


def _grads(params):
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    return params.grad.numpy() if params.grad is not None else np.zeros(params.shape, np.float32)


def _flat(tree, prefix="g"):
    from vihds_tpu_torch.convert import keystr_leaves

    return keystr_leaves(tree, prefix)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' readings (world sizes 2 and 4 side by side), the JAX
    package's sharded steps (computed while the ranks run) and the port's
    unsharded steps."""
    import jax

    from vihds_tpu.config import Config as JConfig
    from vihds_tpu.data.datasets import build_datasets as j_build
    from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
    from vihds_tpu.training import batch_arrays
    from vihds_tpu.vae import VAE as JVAE

    tmp = tmp_path_factory.mktemp("sharded")
    args = make_args(spec("dr_constant_one.yaml"))
    jset = JConfig(args)
    jdata = j_build(args, jset)
    jprog = JProgram(j_parse(jset.params))
    jmodel = JVAE(jset, jdata, jprog)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = batch_arrays(jdata.train.dataset.select(np.arange(UNEVEN[0])))
    batch_np = {k: np.asarray(v) for k, v in jbatch.items()}
    draws = {"u_even": np.asarray(jmodel.sample_u(jax.random.PRNGKey(7), *EVEN)),
             "u_uneven": np.asarray(jmodel.sample_u(jax.random.PRNGKey(8), *UNEVEN))}
    masks = {"mask_even": np.ones(EVEN[0], np.float32),
             "mask_uneven": np.array([1, 1, 1, 1, 0], np.float32)}
    cases = ([dict(name=n, solver=SOLVER[r], mesh=m, dreg=False, u="u_even", mask="mask_even")
              for n, r, m in JAX_CASES]
             + [dict(name=n, solver=SOLVER[r], mesh=m, dreg=d, u="u_uneven", mask="mask_uneven")
                for n, r, m, d in UNEVEN_CASES])
    from vihds_tpu_torch.convert import keystr_leaves

    path = str(tmp / "in.npz")
    np.savez(path, spec=spec("dr_constant_one.yaml"), cases=json.dumps(cases),
             **keystr_leaves(params_np, "p"), **{"batch_" + k: v for k, v in batch_np.items()},
             **draws, **masks)
    worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    argvs, outs = [], {}
    for world in (2, 4):
        out_dir = tmp / ("world%d" % world)
        out_dir.mkdir()
        port = free_port()
        argvs += [[worker, path, str(out_dir), str(r), str(world), str(port)]
                  for r in range(world)]
        outs[world] = out_dir

    import threading

    failure = []

    def ranks():
        try:
            launch(argvs, WALL, rank_env(str(tmp / "boot")))
        except BaseException as e:  # re-raised in the test's thread
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        # the six compiles side by side (XLA compiles outside the GIL)
        from concurrent.futures import ThreadPoolExecutor

        jbatch_even = batch_arrays(jdata.train.dataset.select(np.arange(EVEN[0])))
        with ThreadPoolExecutor(len(JAX_CASES)) as pool:
            refs = [pool.submit(_jax_reference, jmodel, jprog, jparams, jbatch_even,
                                draws["u_even"], masks["mask_even"], route, shape)
                    for _, route, shape in JAX_CASES]
            jax_ref = {name: (ref.result()[0], _flat(ref.result()[1]))
                       for (name, _, _), ref in zip(JAX_CASES, refs)}
    finally:
        thread.join()
    if failure:
        raise failure[0]
    got = {}
    for world, out_dir in outs.items():
        for r in range(world):
            with np.load(str(out_dir / ("rank%d.npz" % r))) as f:
                got.setdefault(world, []).append(dict(f))
    unsharded = {}
    for n, r, m, d in UNEVEN_CASES:
        loss, grads = _port_unsharded(params_np, batch_np, draws["u_uneven"],
                                      masks["mask_uneven"], r, d)
        unsharded[n] = (loss, _flat(grads))
    return dict(got=got, jax=jax_ref, unsharded=unsharded)


def _reading(runs, name, mesh):
    rank0 = runs["got"][mesh[0] * mesh[1]][0]
    loss = float(rank0[name + "/loss"])
    grads = {k[len(name) + 1:]: v for k, v in rank0.items()
             if k.startswith(name + "/") and k != name + "/loss"}
    return loss, grads


def _close(got, want, loss_rtol, leaf_rtol):
    (loss, grads), (ref_loss, ref_grads) = got, want
    np.testing.assert_allclose(loss, ref_loss, rtol=loss_rtol)
    assert sorted(grads) == sorted(ref_grads)
    for key, ref in ref_grads.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(grads[key] - ref).max())
        assert err <= leaf_rtol * max(scale, 1e-30), (key, err, scale)


@pytest.mark.parametrize("name,route,mesh", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_sharded_step_matches_the_jax_package(runs, name, route, mesh):
    _close(_reading(runs, name, mesh), runs["jax"][name], 1e-5, 1e-4)


@pytest.mark.parametrize("name,route,mesh,dreg", UNEVEN_CASES, ids=[c[0] for c in UNEVEN_CASES])
def test_sharded_step_matches_the_unsharded_step(runs, name, route, mesh, dreg):
    _close(_reading(runs, name, mesh), runs["unsharded"][name], 1e-6, 1e-5)


def test_every_rank_holds_the_same_step(runs):
    for world, readings in runs["got"].items():
        assert len(readings) == world
        for other in readings[1:]:
            assert sorted(other) == sorted(readings[0])
            for key, v in readings[0].items():
                np.testing.assert_array_equal(other[key], v, err_msg=key)
