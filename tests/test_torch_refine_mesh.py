"""The samplers and serving over the ranks of a mesh on the CPU, and the
serving CLI's flags.

Two gloo ranks (``tests/torch_parallel_worker.py refine``, the port alone)
each run ``predict.main --mesh_sample 2 --distributed ...`` on a checkpoint
written here, then the five samplers of ``vihds_tpu_torch.refine`` at a
tiny depth (dr_constant_one under ``solver: pallas_midpoint``, 3 series, 4
chains, 3 steps; ``torch_parallel_worker.SAMPLERS``) under a (1, 2) mesh
(chains over 'sample') and a (2, 1) mesh (series over 'data', the second
rank's block padded); the same calls without a mesh run in a process of
their own, as the ranks do (this process has imported JAX, which moves the
last bits of some of the encoder's sums):

* every sampler output of every rank, in both meshes, bit-equal to the one
  process's: every rank draws every chain and reads the gathered
  likelihood, and no sum over the chains is split;
* so are ``pm_refine_shared``'s and ``hmc_refine``'s under ``solver:
  dopri5`` (``torch_parallel_worker.ADAPTIVE_SAMPLERS``): the step
  controller's error norm is the whole batch's on every rank
  (``parallel.block_mean``), so each rank's block takes the steps of one
  process (a norm over the rank's own block, padding included, steps
  otherwise);
* the served npz (rank 0's) bit-equal to the one process's in
  ``per_item_elbo``, ``elbo``, q's moments, the draws and the data; the
  importance-weighted moments are sums over the K samples that the two
  sample ranks add in halves, so they are held to rtol 1e-6, atol 1e-7;
* rank 0 alone writes (its ``Wrote`` line; rank 1 prints none);
* ``predict.main --precision_hidden_layers 0`` serves a checkpoint of
  dr_blackbox_icml trained with that flag (its precision nets without the
  hidden layer the spec's 20 would give);
* the port's ``predict`` parser accepts every flag of
  ``vihds_tpu.predict.create_parser``.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import spec
from tests.torch_parallel_worker import (ADAPTIVE_SAMPLERS, REPO, SAMPLERS, free_port, launch,
                                         rank_env, sampler_setup)
from vihds_tpu_torch import checkpoint as ckpt
from vihds_tpu_torch import predict as P
from vihds_tpu_torch.training import param_leaves

SPEC = spec("dr_constant_one.yaml")
CSV = os.path.join(REPO, "data", "proc141006.csv")
SERIES = 3
MESHES = [(1, 2), (2, 1)]
IW_KEYS = ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance")
WALL = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks and the one-process reference side by side, each a
    process of ``tests/torch_parallel_worker.py refine``."""
    root = tmp_path_factory.mktemp("refine_mesh")
    model, program, params, batch = sampler_setup(SPEC, SERIES)
    ckpt.save(str(root / "ckpt"), 1, {"params": params})
    serve = [SPEC, "--checkpoint", str(root / "ckpt"), "--data", CSV, "--test_samples", "6",
             "--seed", "0", "--save_theta"]
    cfg = dict(spec=SPEC, series=SERIES, meshes=MESHES,
               predict=serve + ["--output", str(root / "mesh.npz"), "--mesh_sample", "2"],
               predict_one=serve + ["--output", str(root / "one_predict.npz")])
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out_dir = root / "out"
    out_dir.mkdir()
    port, port2 = free_port(), free_port()
    worker = [os.path.join(REPO, "tests", "torch_parallel_worker.py"), "refine", str(cfg_path),
              str(out_dir)]
    outs = launch([worker + [str(r), "2", str(port), str(port2)] for r in range(2)]
                  + [worker + ["0", "1", "0", "0"]], WALL, rank_env(str(root / "boot")))
    ranks_out = []
    for name in ("rank0", "rank1", "one"):
        with np.load(str(out_dir / (name + ".npz"))) as f:
            ranks_out.append(dict(f))
    return dict(single=ranks_out.pop(), ranks=ranks_out, stdout=[o for o, _ in outs[:2]],
                mesh_npz=dict(np.load(str(root / "mesh.npz"), allow_pickle=True)),
                one_npz=dict(np.load(str(root / "one_predict.npz"), allow_pickle=True)))


def _equal_over_meshes(runs, name):
    want = {k[len(name) + 1:]: v for k, v in runs["single"].items()
            if k.startswith(name + "/")}
    assert want and all(np.isfinite(v).all() for v in want.values() if v.dtype.kind == "f")
    for n_data, n_sample in MESHES:
        for key, v in want.items():
            got = runs["ranks"][0]["%d%d/%s/%s" % (n_data, n_sample, name, key)]
            np.testing.assert_array_equal(got, v, err_msg="mesh (%d, %d) %s" % (n_data, n_sample,
                                                                                   key))


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_over_two_ranks_equals_one_process(runs, name):
    _equal_over_meshes(runs, name)


@pytest.mark.parametrize("name", list(ADAPTIVE_SAMPLERS))
def test_adaptive_sampler_over_two_ranks_equals_one_process(runs, name):
    _equal_over_meshes(runs, "dopri5/" + name)


def test_every_rank_holds_the_same_chains(runs):
    first, second = runs["ranks"]
    assert sorted(first) == sorted(second)
    for key, v in first.items():
        np.testing.assert_array_equal(second[key], v, err_msg=key)


def test_predict_over_two_ranks_equals_one_process(runs):
    got, want = runs["mesh_npz"], runs["one_npz"]
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        if key in IW_KEYS:
            assert np.isfinite(v).all()
            np.testing.assert_allclose(got[key], v, rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_rank_zero_alone_writes(runs):
    first, second = runs["stdout"]
    assert "Device mesh: data=1 x sample=2" in first and "Device mesh: data=1 x sample=2" in second
    assert [line for line in first.splitlines() if line.startswith("Wrote ")]
    assert not [line for line in second.splitlines() if line.startswith("Wrote ")]


def test_predict_serves_a_checkpoint_of_precision_hidden_layers_0(tmp_path, capsys):
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    bb = spec("dr_blackbox_icml.yaml")
    argv = [bb, "--checkpoint", str(tmp_path / "ck"), "--data", CSV, "--test_samples", "2",
            "--seed", "0", "--output", str(tmp_path / "bb.npz"), "--precision_hidden_layers", "0"]
    args = P.create_parser().parse_args(argv)
    args.heldout = None
    settings = Config(args)
    assert settings.params.n_hidden_decoder_precisions == 0
    model = VAE(settings, build_datasets(args, settings),
                ParamProgram(parse_parameters(settings.params)))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert "hidden" not in params["dec"]["precisions"]
    ckpt.save(str(tmp_path / "ck"), 3, {"params": params})
    out = P.main(argv, device="cpu")
    assert "checkpoint epoch 3" in capsys.readouterr().out
    z = np.load(tmp_path / "bb.npz", allow_pickle=True)
    assert z["iw_predict_mu"].shape[0] == z["observations"].shape[0] > 0
    assert np.isfinite(z["iw_predict_mu"]).all() and np.isfinite(out.merged.elbo)
    # the spec's own architecture cannot take these params
    with pytest.raises(Exception):
        P.main(argv[:-2], device="cpu")
    assert all(torch.isfinite(leaf).all() for leaf in param_leaves(params))


def test_predict_parser_accepts_every_jax_flag():
    from vihds_tpu.predict import create_parser as j_create_parser

    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    missing = flags(j_create_parser()) - flags(P.create_parser())
    assert not missing, sorted(missing)
    args = P.create_parser().parse_args(
        [SPEC, "--data", CSV, "--precision_hidden_layers", "0", "--q_global_init", "prior",
         "--mesh_sample", "2", "--distributed", "127.0.0.1:1,2,0", "--grad_clip_norm", "1.0"])
    assert (args.precision_hidden_layers, args.q_global_init, args.mesh_sample) == (0, "prior", 2)
    assert (args.split, args.heldout, args.checkpoint) == (1, None, None)
