"""Probabilistic core: YAML parameter spec -> static, vectorised program."""

from vihds_tpu_torch.prob.sites import Site, ParamSites, parse_parameters  # noqa: F401
from vihds_tpu_torch.prob.program import ParamProgram  # noqa: F401
