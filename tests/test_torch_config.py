"""The port's ``Config`` on a bad spec, message for message against
``vihds_tpu.config.Config``: a missing spec (with the path under
``specs/`` where one of that name exists), a ``model:`` nested under
``params:``, and no spec at all (``args.yaml`` None: nothing is read)."""

import os

import pytest

from tests.conftest import make_args
from vihds_tpu.config import Config as JConfig
from vihds_tpu_torch.config import Config


def _messages(args_j, args_t):
    with pytest.raises(SystemExit) as j:
        JConfig(args_j)
    with pytest.raises(SystemExit) as t:
        Config(args_t)
    return str(j.value), str(t.value)


@pytest.mark.parametrize("name", ["dr_constant_one.yaml", "no_such_spec.yaml"],
                         ids=["did-you-mean", "no-hint"])
def test_missing_spec_message_matches(name):
    j, t = _messages(make_args(name), make_args(name))
    assert t == j
    assert t.startswith("Spec file not found: %s" % name)
    if name == "dr_constant_one.yaml":
        assert t.endswith(" (did you mean %s?)" % os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "specs", name))
    else:
        assert "did you mean" not in t


@pytest.mark.parametrize("nested", [True, False], ids=["nested", "absent"])
def test_missing_model_key_message_matches(tmp_path, nested):
    bad = tmp_path / "bad.yaml"
    bad.write_text("data:\n  files: [R33S32_Y81C76.csv]\nparams:\n  %s: dr_constant\n"
                   % ("model" if nested else "solver"))
    j, t = _messages(make_args(str(bad)), make_args(str(bad)))
    assert t == j
    assert t.endswith(" (found one nested under params: — move it to the top level)") == nested


def test_no_spec_reads_nothing():
    """``args.yaml`` None: the settings stay empty, as in the JAX package."""
    args_j, args_t = make_args("unused.yaml"), make_args("unused.yaml")
    args_j.yaml = args_t.yaml = None
    j, t = JConfig(args_j), Config(args_t)
    assert vars(t) == vars(j) == {}
