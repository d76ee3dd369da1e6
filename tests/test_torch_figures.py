"""The port's figures on the CPU against the JAX package's.

* Every function of ``vihds_tpu_torch.plotting`` on the synthetic inputs of
  tests/test_plotting.py draws the same artists as ``vihds_tpu.plotting``:
  per Axes its lines' data, its collections' offsets and paths, its patches,
  its title, axis labels, tick labels and texts, and the figure's own
  texts, all compared exactly.
* ``XvalMerge.make_images`` on one results directory writes the same png /
  pdf names as the JAX package's, and the same figure tags into the
  ``xval`` writer.
* ``predict.main --figures`` writes its png and pdf beside the npz.
"""

import os
from types import SimpleNamespace

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("agg")

import matplotlib.pyplot as plt  # noqa: E402
from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator,
)

from tests.conftest import spec  # noqa: E402
from vihds_tpu import plotting as jplot  # noqa: E402
from vihds_tpu.xval import XvalMerge as JXvalMerge  # noqa: E402
from vihds_tpu_torch import checkpoint as ckpt  # noqa: E402
from vihds_tpu_torch import plotting as tplot  # noqa: E402
from vihds_tpu_torch import predict as P  # noqa: E402
from vihds_tpu_torch.utils.attrdict import AttrDict  # noqa: E402
from vihds_tpu_torch.xval import XvalMerge  # noqa: E402


def synth():
    """tests/test_plotting.py's synthetic results."""
    rng = np.random.RandomState(0)
    B, S, T = 8, 4, 20
    return AttrDict(
        settings=AttrDict(
            devices=["devA", "devB"],
            pretty_devices=["A", "B"],
            signals=["OD", "RFP", "YFP", "CFP"],
            conditions=["C6", "C12"],
            separate_conditions=True,
        ),
        devices=np.array([0, 0, 0, 0, 1, 1, 1, 1]),
        treatments=np.log1p(rng.rand(B, 2) * 100),
        times=np.linspace(0, 17, T),
        X_obs=rng.rand(B, S, T),
        iw_predict_mu=rng.rand(B, S, T),
        iw_predict_std=0.1 * rng.rand(B, S, T),
        iw_states=rng.rand(B, 6, T),
        ids=np.arange(B),
        chunk_sizes=np.array([4, 4], dtype=object),
        q_names=["r.mu", "r.prec", "e76.mu", "e76.prec"],
        q_values=[rng.rand(B), 1 + rng.rand(B), rng.rand(2), 1 + rng.rand(2)],
    )


def _weighted_theta(plotting, sample):
    rng = np.random.RandomState(1)
    B, K, n = 8, 10, 3
    iws = rng.rand(B, K)
    iws /= iws.sum(1, keepdims=True)
    np.random.seed(5)  # the resampling draws from numpy's global stream
    return plotting.plot_weighted_theta(["a", "b", "c"], iws, rng.rand(n, B, K), synth().devices,
                                        columns=["a", "b"], sample=sample)


def _combined_treatments(plotting):
    s = synth()
    rng = np.random.RandomState(2)
    B, S, K = 8, 4, 6
    res = AttrDict(
        devices=s.devices,
        treatments=s.treatments,
        X_obs=np.transpose(s.X_obs, (0, 2, 1)),
        importance_weights=np.full((B, K), 1.0 / K),
        PREDICT=rng.rand(B, K, S),
        STD=0.1 * rng.rand(B, K, S),
        pretty_devices=["A", "B"],
        label="m1",
    )
    return plotting.combined_treatments([res], [0, 1])


def _unseparated():
    s = synth()
    s.settings.separate_conditions = False
    return s


FIGURES = {
    "prediction_summary": lambda p, s: p.plot_prediction_summary(
        s.settings.devices, s.settings.signals, s.times, s.X_obs, s.iw_predict_mu,
        s.iw_predict_std, s.devices, "-"),
    "prediction_summary_full_species": lambda p, s: p.plot_prediction_summary(
        s.settings.devices, ["OD", "RFP", "YFP", "CFP", "F530", "F480", "LuxR", "LasR"],
        s.times, s.X_obs, s.iw_predict_mu, s.iw_predict_std, s.devices, "-"),
    "species_summary": lambda p, s: p.species_summary(
        ["OD", "RFP", "YFP", "CFP"], s.treatments, s.devices, s.times, s.iw_states, [0, 1],
        s.settings),
    "species_summary_unnormalised": lambda p, s: p.species_summary(
        ["OD", "RFP", "YFP", "CFP"], s.treatments, s.devices, s.times, s.iw_states, [0, 1],
        s.settings, normalise=False),
    "xval_treatments": lambda p, s: p.xval_treatments(s, [0, 1]),
    "xval_fit_summary": lambda p, s: p.xval_fit_summary(s, 0, separatedInputs=True),
    "xval_fit_summary_joint": lambda p, s: p.xval_fit_summary(_unseparated(), 1),
    "xval_individual_2treatments": lambda p, s: p.xval_individual_2treatments(s, 0),
    "xval_individual": lambda p, s: p.xval_individual(_unseparated(), 1),
    "xval_global_parameters": lambda p, s: p.xval_global_parameters(s),
    "xval_variable_parameters": lambda p, s: p.xval_variable_parameters(s),
    "weighted_theta_resample": lambda p, s: _weighted_theta(p, True),
    "weighted_theta_uniform": lambda p, s: _weighted_theta(p, False),
    "combined_treatments": lambda p, s: _combined_treatments(p),
}


def _texts(items):
    return [t.get_text() for t in items]


def artists(fig):
    """What a figure draws, as plain values: the figure's texts, and per
    Axes its lines, collections, patches, labels and texts."""
    out = [("figure texts", _texts(fig.texts))]
    for i, ax in enumerate(fig.axes):
        out += [
            ((i, "title"), [ax.get_title(loc=loc) for loc in ("left", "center", "right")]),
            ((i, "labels"), [ax.get_xlabel(), ax.get_ylabel()]),
            ((i, "ticks"), [_texts(ax.get_xticklabels()), _texts(ax.get_yticklabels())]),
            ((i, "texts"), _texts(ax.texts)),
            ((i, "lines"), [np.asarray(line.get_xydata()) for line in ax.lines]),
            ((i, "collections"), [
                (np.asarray(c.get_offsets()), [np.asarray(p.vertices) for p in c.get_paths()])
                for c in ax.collections]),
            ((i, "patches"), [np.asarray(p.get_path().vertices) for p in ax.patches]),
        ]
        legend = ax.get_legend()
        if legend is not None:
            out.append(((i, "legend"), _texts(legend.get_texts())))
    return out


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_draws_the_jax_packages_artists(name):
    figs = [FIGURES[name](p, synth()) for p in (jplot, tplot)]
    try:
        got = [artists(f) for f in figs]
        assert len(got[0]) == len(got[1]) and len(figs[0].axes) > 0
        for (key, a), (key_b, b) in zip(*got):
            assert key == key_b
            assert _same(a, b), (name, key)
    finally:
        for f in figs:
            plt.close(f)


def test_gen_treatment_str_matches():
    x = np.log1p(np.array([25000.0, 0.0]))
    assert tplot.gen_treatment_str(["C6", "C12"], x) == jplot.gen_treatment_str(["C6", "C12"], x)
    assert tplot.gen_treatment_str(["C6", "C12"], x, unit="nM") == jplot.gen_treatment_str(
        ["C6", "C12"], x, unit="nM")


def _write_results(directory):
    """A results directory of synthetic xval arrays (the synthetic inputs
    above, as two folds of four series), written by the port's
    ``XvalMerge.save``; returns the settings both packages read it with."""
    s = synth()
    settings = SimpleNamespace(data=s.settings, trainer=SimpleNamespace(tb_log_dir=directory))
    m = XvalMerge(SimpleNamespace(epochs=3), settings)
    m.elbo = np.array([-10.0, -12.0])
    m.elbo_list = np.empty(2, dtype=object)
    m.elbo_list[0], m.elbo_list[1] = [-20.0, -10.0], [-25.0, -12.0]
    m.q_names = s.q_names
    m.q_values = s.q_values
    m.theta = [np.zeros((4, 4, 3), np.float32)] * 2
    for name in ("iw_predict_mu", "iw_predict_std", "iw_states", "devices", "treatments",
                 "X_obs", "chunk_sizes", "ids", "times"):
        setattr(m, name, s[name])
    m.species_names = ["OD", "RFP", "YFP", "CFP", "F530", "F480"]
    m.save()
    return settings


def _tags(directory):
    acc = EventAccumulator(directory)
    acc.Reload()
    return {kind: sorted(acc.Tags()[kind]) for kind in ("images", "scalars")}


def test_make_images_writes_the_jax_packages_files_and_tags(tmp_path):
    source = str(tmp_path / "results")
    os.makedirs(source)
    settings = _write_results(source)
    names = {}
    for package, cls in (("jax", JXvalMerge), ("port", XvalMerge)):
        out = str(tmp_path / package)
        os.makedirs(out)
        merge = cls(SimpleNamespace(epochs=3),
                    SimpleNamespace(data=settings.data, trainer=SimpleNamespace(tb_log_dir=out)))
        merge.load(source)
        merge.make_writer(out)
        merge.make_images()
        merge.close_writer()
        names[package] = (sorted(os.listdir(out)), _tags(os.path.join(out, "xval")))
    files, tags = names["port"]
    assert names["port"] == names["jax"]
    figures = {n for n in files if n.endswith((".png", ".pdf"))}
    assert {"xval_fit.png", "xval_fit.pdf", "xval_treatments.pdf", "xval_species.png",
            "xval_summary_devA.png", "xval_individual_devB.pdf"} <= figures
    # the fit, treatments, species and both parameter figures, and a summary
    # and an individual figure per device, each as png and pdf
    assert len(figures) == 2 * (5 + 2 * 2)
    assert "Summary" in tags["images"] and "Device_Individual/devB" in tags["images"]


def test_predict_main_writes_its_figure(tmp_path, capsys):
    """``predict.main --figures`` on a checkpoint of dr_constant_one (its
    seeded initial params, saved as training saves them)."""
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    args = SimpleNamespace(yaml=spec("dr_constant_one.yaml"), seed=0, folds=4, split=1,
                           heldout=None)
    settings = Config(args)
    data = build_datasets(args, settings)
    model = VAE(settings, data, ParamProgram(parse_parameters(settings.params)))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    ckpt.save(str(tmp_path / "ckpts"), 1, {"params": params, "epoch": 1})
    csv = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                       "proc141006.csv")
    P.main([spec("dr_constant_one.yaml"), "--checkpoint", str(tmp_path / "ckpts"), "--data",
            csv, "--test_samples", "4", "--output", str(tmp_path / "out.npz"), "--figures"],
           device="cpu")
    assert "Wrote %s.png/.pdf" % (tmp_path / "out") in capsys.readouterr().out
    assert {"out.npz", "out.png", "out.pdf"} <= set(os.listdir(tmp_path))
    assert os.path.getsize(tmp_path / "out.png") > 0 and os.path.getsize(tmp_path / "out.pdf") > 0
