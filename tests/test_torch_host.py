"""The PyTorch port's host layer against the JAX package: the same spec and
CSVs must give the same arrays, folds, sites and priors (exactly: both
packages run the same numpy code on the same files)."""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest

from tests.conftest import make_args, spec
from vihds_tpu.config import Config as JConfig
from vihds_tpu.data.datasets import build_datasets as j_build
from vihds_tpu.predict import load_new_data as j_load_new_data
from vihds_tpu.prob import ParamProgram as JProgram, parse_parameters as j_parse
from vihds_tpu_torch.config import Config as TConfig
from vihds_tpu_torch.data import procdata as t_procdata
from vihds_tpu_torch.data.datasets import build_datasets as t_build
from vihds_tpu_torch.predict import load_new_data as t_load_new_data
from vihds_tpu_torch.prob import ParamProgram as TProgram, parse_parameters as t_parse

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SPECS = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(os.path.dirname(DATA), "specs", "*.yaml")))


def both(spec_name, split=1):
    jargs = make_args(spec(spec_name), split=split)
    targs = SimpleNamespace(yaml=spec(spec_name), seed=0, folds=4, split=split, heldout=None)
    jset, tset = JConfig(jargs), TConfig(targs)
    return (jargs, jset, j_build(jargs, jset)), (targs, tset, t_build(targs, tset))


@pytest.mark.parametrize("spec_name", SPECS)
def test_dataset_arrays_match(spec_name):
    (_, jset, jdata), (_, tset, tdata) = both(spec_name)
    jd, td = jdata.train.dataset, tdata.train.dataset
    # merge: false keeps one dataset per file; its report view spans them all
    assert hasattr(jd, "files") == hasattr(td, "files") == (not jset.data.merge)
    views = [(jd, td)]
    if not jset.data.merge:
        views = list(zip(jd.files, td.files)) + [(jd.select(np.arange(len(jd))),
                                                   td.select(np.arange(len(td))))]
    for a_set, b_set in views:
        for name in ("devices", "dev_1hot", "inputs", "times", "observations"):
            a, b = getattr(a_set, name), getattr(b_set, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jd.scales), np.asarray(td.scales))
    assert jset.data.device_depth == tset.data.device_depth
    for k, v in jset.data.relevance_vectors.items():
        np.testing.assert_array_equal(v, tset.data.relevance_vectors[k])
    assert dict(jset.params) == dict(tset.params)


@pytest.mark.parametrize("spec_name", SPECS)
def test_fold_splits_match(spec_name):
    for split in (1, 2, 3, 4):
        (_, _, jdata), (_, _, tdata) = both(spec_name, split)
        np.testing.assert_array_equal(jdata.train.indices, tdata.train.indices)
        np.testing.assert_array_equal(jdata.test.indices, tdata.test.indices)
        assert (jdata.n_train, jdata.n_test, jdata.depth, jdata.n_conditions) == (
            tdata.n_train, tdata.n_test, tdata.depth, tdata.n_conditions
        )


@pytest.mark.parametrize("spec_name", SPECS)
def test_sites_and_priors_match(spec_name):
    (_, jset, _), (_, tset, _) = both(spec_name)
    jp, tp = JProgram(j_parse(jset.params)), TProgram(t_parse(tset.params))
    assert jp.names == tp.names
    assert [s.tier for s in jp.sites.ordered] == [s.tier for s in tp.sites.ordered]
    assert [s.kind for s in jp.sites.ordered] == [s.kind for s in tp.sites.ordered]
    for name in ("prior_mu", "prior_prec", "const_value", "is_lognormal", "is_constant"):
        np.testing.assert_array_equal(getattr(jp, name), getattr(tp, name), err_msg=name)
    for a, b in zip(jp.clip_bounds(4), tp.clip_bounds(4)):
        np.testing.assert_array_equal(a, b)
    assert (jp.local_slice, jp.global_cond_slice, jp.global_slice, jp.constant_slice) == (
        tp.local_slice, tp.global_cond_slice, tp.global_slice, tp.constant_slice
    )


@pytest.mark.parametrize("csv", ["proc141021.csv", "proc141028.csv"])
def test_serving_loader_matches(csv):
    """predict.load_new_data re-applies the training grid and scales the
    same way in both packages."""
    (_, jset, jdata), (_, tset, tdata) = both("dr_constant_icml.yaml")
    path = os.path.join(DATA, csv)
    jh = j_load_new_data([path], jset, jdata.train.dataset)
    th = t_load_new_data([path], tset, tdata.train.dataset)
    for name in ("devices", "dev_1hot", "inputs", "times", "observations"):
        np.testing.assert_array_equal(jh[name], th[name], err_msg=name)


def test_process_condition_and_errors():
    assert dict(t_procdata.process_condition("C6=25000;C12=0")) == {"C6": 25000.0, "C12": 0.0}
    assert dict(t_procdata.process_condition("")) == {}
    with pytest.raises(ValueError, match="Unparseable condition string"):
        t_procdata.process_condition("C6=abc")
    tset = TConfig(SimpleNamespace(yaml=spec("dr_constant_one.yaml"), seed=0))
    with pytest.raises(FileNotFoundError, match="not found"):
        t_procdata.load("no_such_file.csv", tset.data)
