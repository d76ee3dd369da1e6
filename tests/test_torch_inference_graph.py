"""The port's inference graph (``inference_graph``, ``run_inference_graph``)
against the JAX package's on the CPU: staging and each node's arguments
field by field, posterior-to-prior propagation on the same upstream
``xval_q_*`` files (settings and printed lines equal), the warning on an edge
whose upstream has no such posterior, a node with ``mesh: auto`` training, a
2-node graph end to end and resumed, and
one ``--jobs 2`` stage in spawn workers."""

import os

import numpy as np
import pytest
import yaml

from tests.conftest import spec
from tests.test_inference_graph import write_graph
from vihds_tpu import inference_graph as j_ig
from vihds_tpu import run_inference_graph as j_rig
from vihds_tpu.config import Config as JConfig
from vihds_tpu_torch import call_run_xval
from vihds_tpu_torch import inference_graph as ig
from vihds_tpu_torch import run_inference_graph as rig
from vihds_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _node(name, **extra):
    """A dr_constant_one node at a test's size: 1 epoch of 2 folds (one
    fold holds every series out, in both packages), K=5."""
    doc = {"spec": spec("dr_constant_one.yaml"), "experiment": name, "seed": 0, "epochs": 1,
           "test_epoch": 1, "train_samples": 5, "test_samples": 5, "plot_epoch": 0, "folds": 2}
    doc.update(extra)
    return doc


def _write(tmp_path, nodes, edges, name="graph.yaml"):
    path = tmp_path / name
    path.write_text(yaml.dump({"nodes": nodes, "edges": edges}))
    return str(path)


def _edge(src, dst, param="r"):
    return {"from": {"node": src, "parameter": param}, "to": {"node": dst, "parameter": param}}


FEATURES = {
    "a": {"spec": spec("dr_constant_one.yaml"), "experiment": "a", "folds": 2,
          "vmap_folds": True, "mesh": "auto", "dreg": True, "grad_clip_norm": 10.0,
          "q_global_init": "prior"},
    "b": {"spec": spec("dr_constant_one.yaml"), "experiment": "b",
          "heldout": "R33S32_Y81C76", "mesh_data": 2, "mesh_sample": 4},
    "c": {"spec": spec("dr_constant_one.yaml"), "experiment": "c", "split": 3, "seed": 4,
          "epochs": 7, "test_epoch": 3, "plot_epoch": 2, "gpu": 1, "train_samples": 9,
          "test_samples": 11, "precision_hidden_layers": 0, "checkpoint_epoch": 2,
          "verbose": True},
}


@pytest.mark.parametrize("graph", ["chain", "features", "demo"])
def test_stages_and_node_args_match_the_jax_package(tmp_path, graph):
    """Each node's stage and its parsed arguments (every field) equal the
    JAX package's: tests/test_inference_graph.py's 2-node chain, its
    graph of node features (and a node with a split and every other key),
    and the shipped demo graph."""
    if graph == "chain":
        path = write_graph(tmp_path)
    elif graph == "features":
        path = _write(tmp_path, FEATURES, [_edge("a", "c"), _edge("b", "c")])
    else:
        path = os.path.join(REPO, "inferencegraphs", "demo_graph.yaml")
    jg = j_ig.create_inference_graph(path, "tg")
    tg = ig.create_inference_graph(path, "tg")
    assert list(tg) == list(jg)
    for name in jg:
        assert tg[name].stage == jg[name].stage
        assert vars(tg[name].args) == vars(jg[name].args)
        assert [(e.source.name, e.sourceParam, e.target.name, e.targetParam)
                for e in tg[name].incoming] == [
            (e.source.name, e.sourceParam, e.target.name, e.targetParam)
            for e in jg[name].incoming]
    j_stages = j_ig.arrange_by_stage(jg.values())
    t_stages = ig.arrange_by_stage(tg.values())
    assert {s: [n.name for n in ns] for s, ns in t_stages.items()} == {
        s: [n.name for n in ns] for s, ns in j_stages.items()}
    if graph == "demo":
        assert {n: tg[n].stage for n in tg} == {"auto": 0, "prpr": 1, "dr": 2}


def _upstream(tmp_path):
    """Seeded upstream ``xval_q_*`` files: four folds' mu and prec of r and
    K (object arrays, as ``XvalMerge.save`` writes them)."""
    upstream = tmp_path / "updir"
    upstream.mkdir()
    rng = np.random.default_rng(3)
    names = ["r.mu", "r.prec", "K.mu", "K.prec"]
    values = np.empty(4, dtype=object)
    for i, name in enumerate(names):
        v = rng.uniform(0.5, 3.0, size=4)
        values[i] = v if name.endswith(".prec") else np.log(v)
    np.save(upstream / "xval_q_values.npy", values)
    (upstream / "xval_q_names.txt").write_text("\n".join(names))
    return str(upstream), values


@pytest.mark.parametrize("param", ["r", "aR"], ids=["propagated", "no-posterior"])
def test_propagate_params_matches_the_jax_package(tmp_path, capsys, param):
    """The same upstream files into both packages' ``propagate_params``:
    the downstream settings equal (the prior LogNormal(mu = mean mu, sigma =
    1/sqrt(harmonic-pooled precision))) and the printed lines equal; an
    edge whose upstream has no posterior for its parameter is skipped with
    the same WARNING line."""
    updir, values = _upstream(tmp_path)
    path = _write(tmp_path, {"up": _node("up"), "down": _node("down")},
                  [_edge("up", "down", param)])
    jg = j_ig.create_inference_graph(path, "tg")
    tg = ig.create_inference_graph(path, "tg")
    jset, tset = JConfig(jg["down"].args), Config(tg["down"].args)
    capsys.readouterr()
    j_rig.propagate_params(jg["down"], jset, {"up": updir})
    j_out = capsys.readouterr().out
    rig.propagate_params(tg["down"], tset, {"up": updir})
    t_out = capsys.readouterr().out
    assert t_out == j_out
    assert str(tset.params) == str(jset.params)
    if param == "r":
        prior = tset.params["local"]["r"]
        assert prior["distribution"] == "LogNormal"
        np.testing.assert_allclose(prior["mu"], np.mean(values[0]))
        np.testing.assert_allclose(prior["sigma"],
                                   1.0 / np.sqrt(4.0 / np.sum(1.0 / values[1])))
        assert "Target parameter for down is r (local tier): LogNormal" in t_out
    else:
        assert "WARNING: up has no posterior for 'aR'; skipping edge to down.aR" in t_out


def test_pooled_prec_is_harmonic():
    xs = [2.0, 4.0, 8.0]
    assert rig.pooled_prec(xs) == j_rig.pooled_prec(xs) == 3 / (1 / 2 + 1 / 4 + 1 / 8)


def test_mesh_node_trains(tmp_results, monkeypatch):
    """A node of the last stage with ``mesh: auto`` trains (one process: one
    rank, unsharded) and completes."""
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    path = _write(tmp_results, {"up": _node("up"), "down": _node("down", mesh="auto")},
                  [_edge("up", "down")])
    result = rig.main([path, "--graph", "tg"], device="cpu")
    assert sorted(result) == ["down", "up"]
    assert open(os.path.join(result["down"], "completed.txt")).read() == "tg/down"


def test_vmap_folds_node_trains(tmp_results, monkeypatch, capsys):
    """A node with ``vmap_folds`` trains its folds in one batched run and
    completes."""
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    path = _write(tmp_results, {"one": _node("one", vmap_folds=True)}, [], "v.yaml")
    result = rig.main([path, "--graph", "tv"], device="cpu")
    out = capsys.readouterr().out
    assert "Training: 2 folds vmapped (one batched program)" in out and "falling back" not in out
    assert open(os.path.join(result["one"], "completed.txt")).read() == "tv/one"


def test_graph_end_to_end_and_resumed(tmp_results, monkeypatch, capsys):
    """A 2-node dr_constant_one graph (1 epoch, 2 folds, K=5): both nodes
    complete, the downstream's propagatedParams.txt holds the prior
    recomputed from the upstream's own files, and a second run skips both
    nodes, leaving their completed.txt untouched."""
    monkeypatch.setattr(call_run_xval, "write_figures", lambda merge: None)
    path = _write(tmp_results, {"up": _node("up"), "down": _node("down")},
                  [_edge("up", "down")], "g.yaml")
    result = rig.main([path, "--graph", "tg"], device="cpu")
    root = tmp_results / "tg"
    assert sorted(result) == ["down", "up"]
    for name, d in result.items():
        assert os.path.dirname(d) == str(root)
        assert open(os.path.join(d, "completed.txt")).read() == "tg/" + name
        assert "xval_q_values.npy" in os.listdir(d)
    values = np.load(os.path.join(result["up"], "xval_q_values.npy"), allow_pickle=True)
    names = open(os.path.join(result["up"], "xval_q_names.txt")).read().split()
    mu = float(np.mean(values[names.index("r.mu")]))
    sigma = 1.0 / np.sqrt(float(rig.pooled_prec(values[names.index("r.prec")])))
    prop = open(os.path.join(result["down"], "propagatedParams.txt")).read()
    assert "'r': AttrDict({'distribution': 'LogNormal', 'mu': %r, 'sigma': %r})" % (
        mu, sigma) in prop
    mtimes = {d: os.path.getmtime(os.path.join(d, "completed.txt")) for d in result.values()}
    capsys.readouterr()
    again = rig.main([path, "--graph", "tg"], device="cpu")
    out = capsys.readouterr().out
    assert again == result
    assert "Node up already completed." in out and "Node down already completed." in out
    for d, m in mtimes.items():
        assert os.path.getmtime(os.path.join(d, "completed.txt")) == m


def test_jobs_runs_one_stage_in_spawn_workers(tmp_results):
    """``--jobs 2`` on two independent nodes: both complete, each in a
    spawn worker process."""
    path = _write(tmp_results, {"left": _node("left"), "right": _node("right", seed=1)}, [],
                  "jobs.yaml")
    result = rig.main([path, "--graph", "tj", "--jobs", "2"], device="cpu")
    assert sorted(result) == ["left", "right"]
    for name, d in result.items():
        assert open(os.path.join(d, "completed.txt")).read() == "tj/" + name
