"""The port's multi-process launch (``vihds_tpu_torch.parallel.multihost``)
and its fold mesh (``xfold.make_fold_mesh``) on the CPU.

The CLI runs go through ``run_xval.main`` in their own processes (the port
alone, ``tests/torch_parallel_worker.launch``: every launch has a wall
limit and kills its ranks on expiry), as ``tests/test_multihost_cli.py``
runs the JAX package's, on ``dr_constant_one`` (4 epochs, eval every 2,
K = 10 in training over ``--mesh_sample 2`` and K = 9 in evaluation, which
two ranks do not divide):

* two gloo ranks against the single-process run: ``xval_elbo`` to rtol
  1e-4, ``q_values`` and ``iw_predict_mu`` to rtol 2e-3, atol 2e-4 (that
  test's tolerances);
* rank 0 alone writes (one experiment directory, with ``completed.txt``;
  rank 1 writes nothing), and each rank's first line names its backend;
* checkpoint at epoch 2 and resume over two ranks replay the continuous
  two-rank run's validation ELBOs (rtol 1e-5);
* ``merge: false`` (``dr_constant_icml_unmerged``, 1 epoch, K = 2) over
  ``--mesh_data 2``, whose per-file row counts two ranks do not all divide,
  against the single-process run (the same tolerances).

And, against the JAX package, word for word: the bad factorisation's
``AssertionError``, ``broadcast_string``'s ``ValueError``, the one-line stop
of ``--distributed auto`` without torchrun's variables, ``make_fold_mesh``'s
device counts and ``run_all_folds``' decisions and lines; ``VmapXval`` on a
fold mesh of two CPU devices equals the unsharded batched run bit for bit.
"""

import os
import re

import numpy as np
import pytest
import torch

from tests.conftest import spec
from tests.torch_parallel_worker import cli_argvs, launch, rank_env
from vihds_tpu_torch import parallel, run_xval, xfold
from vihds_tpu_torch.config import Config, Trainer
from vihds_tpu_torch.parallel import multihost

CLI = [spec("dr_constant_one.yaml"), "--experiment", "mh", "--seed", "0", "--epochs", "4",
       "--test_epoch", "2", "--train_samples", "10", "--test_samples", "9", "--plot_epoch", "0"]
UNMERGED = [spec("dr_constant_icml_unmerged.yaml"), "--experiment", "mh", "--seed", "0",
            "--epochs", "1", "--test_epoch", "1", "--train_samples", "2", "--test_samples", "2",
            "--plot_epoch", "0"]
WALL = 240
VAL = re.compile(r"val \(iwae-elbo = ([-\d.]+)")


def _artifacts(results_dir):
    (exp,) = [d for d in os.listdir(results_dir) if d.startswith("mh")]
    exp_dir = os.path.join(results_dir, exp)
    arrs = {name: np.load(os.path.join(exp_dir, "xval_%s.npy" % name), allow_pickle=True)
            for name in ("elbo", "iw_predict_mu", "q_values")}
    arrs["q_values"] = np.concatenate([np.ravel(np.asarray(v)) for v in arrs["q_values"]])
    return exp_dir, arrs


def _same_artifacts(mp_dir, sp_dir):
    _, mp = _artifacts(mp_dir)
    _, sp = _artifacts(sp_dir)
    np.testing.assert_allclose(mp["elbo"], sp["elbo"], rtol=1e-4)
    np.testing.assert_allclose(mp["q_values"], sp["q_values"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mp["iw_predict_mu"], sp["iw_predict_mu"], rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Every launch of the file: the two-rank run, the single-process run,
    the two-rank run checkpointed at epoch 2 and the two ``merge: false``
    runs side by side, then the two-rank resume.  {name: (results dir, the
    processes' stdouts, their working directory)}."""
    tmp = tmp_path_factory.mktemp("multihost")
    runs = {"mp": (CLI + ["--mesh_sample", "2"], 2), "sp": (CLI, 0),
            "half": (CLI + ["--mesh_sample", "2", "--epochs", "2", "--checkpoint_epoch", "2"], 2),
            "ump": (UNMERGED + ["--mesh_data", "2"], 2), "usp": (UNMERGED, 0)}

    def start(names):
        argvs, where = [], []
        for name in names:
            argv, n = runs[name]
            for rank_argv in cli_argvs("run_xval", argv, n):
                argvs.append(rank_argv)
                where.append(name)
        envs = {}
        for name in names:
            os.makedirs(str(tmp / name / "cwd"))
            envs[name] = rank_env(str(tmp / "boot"), {"INFERENCE_RESULTS_DIR": str(tmp / name)})
        # one launch per run, all started together
        import threading

        outs, errors = {}, []

        def one(name):
            mine = [a for a, w in zip(argvs, where) if w == name]
            try:
                outs[name] = [o for o, _ in launch(mine, WALL, envs[name],
                                                   cwd=str(tmp / name / "cwd"))]
            except BaseException as e:  # re-raised in the fixture's thread
                errors.append(e)

        threads = [threading.Thread(target=one, args=(name,)) for name in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return outs

    outs = start(["mp", "sp", "half", "ump", "usp"])
    (exp_half,) = [d for d in os.listdir(str(tmp / "half")) if d.startswith("mh")]
    ckpt_dir = os.path.join(str(tmp / "half"), exp_half, "checkpoints_1_of_4")
    runs["res"] = (CLI + ["--mesh_sample", "2", "--resume_from", ckpt_dir], 2)
    outs.update(start(["res"]))
    return {name: (str(tmp / name), outs[name], str(tmp / name / "cwd")) for name in outs}


def test_two_ranks_match_the_single_process_run(cli):
    _same_artifacts(cli["mp"][0], cli["sp"][0])


def test_rank_zero_alone_writes(cli):
    results, (out0, out1), cwd = cli["mp"]
    exp_dir, _ = _artifacts(results)
    assert [d for d in os.listdir(results) if d.startswith("mh")] == [os.path.basename(exp_dir)]
    assert os.path.exists(os.path.join(exp_dir, "completed.txt"))
    assert "Saving results" in out0 and "Saving results" not in out1
    assert os.listdir(cwd) == []  # no cache or checkpoint beside either rank
    assert VAL.findall(out0) == VAL.findall(out1)  # lockstep: the same ELBOs


def test_each_rank_names_its_backend_first(cli):
    for rank, out in enumerate(cli["mp"][1]):
        assert out.splitlines()[0] == ("torch.distributed: process %d of 2 (backend gloo, "
                                       "device cpu)" % rank)
        assert "Device mesh: data=1 x sample=2" in out


def test_resume_replays_the_continuous_run(cli):
    v_cont = [float(v) for v in VAL.findall(cli["mp"][1][0])]
    v_half = [float(v) for v in VAL.findall(cli["half"][1][0])]
    out = cli["res"][1][0]
    assert len(v_cont) == 2 and "Resumed from" in out
    np.testing.assert_allclose(v_half, v_cont[:1], rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in VAL.findall(out)], v_cont[1:], rtol=1e-5)


def test_unmerged_over_two_ranks_matches_the_single_process_run(cli):
    assert "Device mesh: data=2 x sample=1" in cli["ump"][1][0]
    _same_artifacts(cli["ump"][0], cli["usp"][0])


def test_messages_equal_the_jax_packages():
    import jax

    from vihds_tpu import parallel as jparallel
    from vihds_tpu.parallel import multihost as jmultihost

    for n, n_data, n_sample in ((1, 2, None), (2, None, 3), (3, 2, 2), (4, 3, None)):
        with pytest.raises(AssertionError) as want:
            jparallel.make_mesh(n_data=n_data, n_sample=n_sample, devices=jax.devices()[:n])
        with pytest.raises(AssertionError) as got:
            parallel.make_mesh(n_data=n_data, n_sample=n_sample, devices=n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jmultihost.broadcast_string("x" * 5000)
    with pytest.raises(ValueError) as got:
        multihost.broadcast_string("x" * 5000)
    assert str(got.value) == str(want.value) == "broadcast_string: 5000 bytes > max_len 4096"
    assert multihost.broadcast_string("runs/a") == "runs/a"


def test_distributed_auto_without_torchrun_stops_in_one_line(tmp_results, monkeypatch):
    for name in multihost.TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as stop:
        run_xval.main([spec("dr_constant_one.yaml"), "--distributed", "auto"], device="cpu")
    assert str(stop.value) == ("--distributed auto needs torchrun's environment; MASTER_ADDR, "
                               "MASTER_PORT, RANK, WORLD_SIZE not set")
    assert os.listdir(tmp_results) == []


def test_make_fold_mesh_takes_the_jax_packages_device_counts():
    import jax

    from vihds_tpu import xfold as j_xfold

    for folds in range(1, 7):
        for n in range(1, 9):
            want = j_xfold.make_fold_mesh(folds, devices=jax.devices()[:n])
            got = xfold.make_fold_mesh(folds, [torch.device("cpu")] * n)
            assert (got and got.shape["fold"]) == (want and want.shape["fold"]), (folds, n)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_run_all_folds_decides_and_says_as_the_jax_package(n_dev, monkeypatch, capsys):
    """On ``n_dev`` devices, 3 and 4 folds under ``--mesh auto``, an explicit
    ``--mesh_data`` and no mesh flag: the printed decision and the fold mesh
    handed to the runner (a stub)."""
    import jax

    from vihds_tpu import run_xval as j_run_xval
    from vihds_tpu import xfold as j_xfold
    from vihds_tpu.config import Config as JConfig

    def stub(*a, fold_mesh=None, **k):
        print("runner on %s devices" % (fold_mesh and fold_mesh.shape["fold"]))
        raise _Stop()

    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(j_xfold.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(j_xfold, "VmapXval", stub)
    monkeypatch.setattr(xfold, "VmapXval", stub)
    monkeypatch.setattr(xfold, "local_devices", lambda d: [torch.device("cpu")] * n_dev)
    for folds in (3, 4):
        for flags in (["--mesh", "auto"], ["--mesh_data", "2"], []):
            argv = [spec("dr_constant_one.yaml"), "--seed", "0", "--folds", str(folds)] + flags
            outs = []
            for parser, config, call in (
                    (j_run_xval.create_parser(False), JConfig, j_xfold.run_all_folds),
                    (run_xval.create_parser(False), Config,
                     lambda a, s: xfold.run_all_folds(a, s, device="cpu"))):
                args = parser.parse_args(argv)
                try:
                    assert call(args, config(args)) is None
                except _Stop:
                    pass
                outs.append(capsys.readouterr().out)
            assert outs[0] == outs[1], (folds, flags)
            assert "runner on" in outs[0] or "falling back" in outs[0]


def test_vmap_folds_on_a_fold_mesh_equals_the_unsharded_run(tmp_results):
    """Two CPU devices, one fold a device: every fold's ELBOs, predictions
    and final params equal the batched run's on one device, bit for bit."""
    args = run_xval.create_parser(False).parse_args(
        [spec("dr_constant_one.yaml"), "--seed", "0", "--epochs", "2", "--test_epoch", "2",
         "--folds", "2", "--train_samples", "4", "--test_samples", "4", "--plot_epoch", "0"])
    runs = {}
    for tag, mesh in (("plain", None), ("sharded", xfold.FoldMesh(["cpu", "cpu"]))):
        args.experiment = "foldmesh_" + tag
        settings = Config(args)
        settings.trainer = Trainer(args, log_dir=str(tmp_results / tag))
        runner = xfold.VmapXval(args, settings, device="cpu", fold_mesh=mesh)
        runs[tag] = (runner.run(), runner.final_params)
    (plain, p_plain), (sharded, p_sharded) = runs["plain"], runs["sharded"]
    for a, b in zip(plain, sharded):
        np.testing.assert_array_equal(np.asarray(a.elbo_list), np.asarray(b.elbo_list))
        np.testing.assert_array_equal(a.iw_predict_mu, b.iw_predict_mu)
    from vihds_tpu_torch.training import param_leaves

    for a, b in zip(param_leaves(p_plain), param_leaves(p_sharded)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
