"""Parse the YAML ``params:`` tree into flat per-parameter Site records.

The port's own copy of ``vihds_tpu.prob.sites``: tiers ``constant`` /
``shared`` / ``global`` / ``global_conditioned`` / ``local``, shared
templates, sigma-vs-prec specification and string-valued dependency slots,
parsed into a plain list of records that ``ParamProgram`` compiles.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

NORMAL = "Normal"
LOGNORMAL = "LogNormal"
TRUNCATED = "TruncatedNormal"
KUMARASWAMY = "Kumaraswamy"
CONSTANT = "Constant"

# Tiers in theta-concatenation order.
TIER_ORDER = ("local", "global_cond", "global", "constant")


@dataclass
class Site:
    """One latent parameter: its distribution family, tier, initialisation and
    (optional) dependency slots."""

    name: str
    tier: str  # 'local' | 'global_cond' | 'global' | 'constant'
    kind: str  # NORMAL | LOGNORMAL | TRUNCATED | KUMARASWAMY | CONSTANT
    # Initial / prior natural parameters (Normal family: mu & prec;
    # Kumaraswamy: a & b stored in mu & prec slots; Constant: value in mu).
    init_mu: float = 0.0
    init_prec: float = 1.0
    # Dependency slots: name of another site whose *sample* feeds this slot.
    mu_dep: Optional[str] = None
    prec_dep: Optional[str] = None
    # Conditioning flags for the amortised posterior head of this site's tier.
    cond_devices: bool = False
    cond_treatments: bool = False
    # Extra static parameters.
    a: float = -np.inf  # TruncatedNormal left bound
    b: float = np.inf  # TruncatedNormal right bound
    zmin: float = 0.0  # Kumaraswamy support
    zmax: float = 1.0
    # Free-parameter initial values (what Q_Global trains):
    # Normal family: [init_mu, log(init_prec)]; Kumaraswamy: [log a, log b];
    # Constant: [value].
    init_free: tuple = field(default_factory=tuple)

    def __post_init__(self):
        if not self.init_free:
            if self.kind == CONSTANT:
                self.init_free = (float(self.init_mu),)
            elif self.kind == KUMARASWAMY:
                self.init_free = (float(np.log(self.init_mu)), float(np.log(self.init_prec)))
            else:
                self.init_free = (float(self.init_mu), float(np.log(self.init_prec)))


def _site_from_spec(name, spec, tier, conditioning):
    """One YAML distribution spec -> Site."""
    if "distribution" not in spec:
        return None
    kind = spec["distribution"]
    cond = conditioning or {}
    common = dict(
        tier=tier,
        cond_devices=bool(cond.get("devices", False)),
        cond_treatments=bool(cond.get("treatments", False)),
    )
    if kind in (NORMAL, LOGNORMAL, TRUNCATED, "TruncNormal"):
        if kind == "TruncNormal":
            kind = TRUNCATED
        mu = spec.get("mu", 0.0)
        sigma = spec.get("sigma", None)
        prec = spec.get("prec", None)
        mu_dep = mu if isinstance(mu, str) else None
        prec_dep = prec if isinstance(prec, str) else None
        init_mu = 0.0 if mu_dep is not None else float(mu)
        if prec is not None and prec_dep is None:
            init_prec = float(prec)
        elif sigma is not None and not isinstance(sigma, str):
            init_prec = 1.0 / float(sigma) ** 2
        else:
            init_prec = 1.0
        site = Site(
            name,
            kind=kind,
            init_mu=init_mu,
            init_prec=init_prec,
            mu_dep=mu_dep,
            prec_dep=prec_dep,
            a=float(spec.get("a", -np.inf)),
            b=float(spec.get("b", np.inf)),
            **common,
        )
    elif kind == KUMARASWAMY:
        a = spec.get("a", None)
        b = spec.get("b", None)
        if a is None or b is None:
            raise ValueError("Kumaraswamy %s needs both a and b" % name)
        site = Site(
            name,
            kind=KUMARASWAMY,
            init_mu=float(a) if not isinstance(a, str) else 1.0,
            init_prec=float(b) if not isinstance(b, str) else 1.0,
            mu_dep=a if isinstance(a, str) else None,
            prec_dep=b if isinstance(b, str) else None,
            zmin=float(spec.get("zmin", 0.0)),
            zmax=float(spec.get("zmax", 1.0)),
            **common,
        )
    elif kind == CONSTANT:
        site = Site(name, kind=CONSTANT, init_mu=float(spec.get("value", 0.0)), **common)
    else:
        raise ValueError("Cannot instantiate distribution kind %r for %s" % (kind, name))
    return site


class ParamSites:
    """All Sites of a spec, grouped by tier and held in theta order."""

    def __init__(self, local, global_cond, global_, constant):
        self.local = local
        self.global_cond = global_cond
        self.global_ = global_
        self.constant = constant

    @property
    def ordered(self):
        return list(self.local) + list(self.global_cond) + list(self.global_) + list(self.constant)

    def counts(self):
        """(n_local, n_global_cond, n_global, n_constant)."""
        return (len(self.local), len(self.global_cond), len(self.global_), len(self.constant))

    @property
    def n_theta(self):
        return sum(self.counts())

    @property
    def names(self):
        return [s.name for s in self.ordered]


def parse_parameters(params_dict):
    """YAML ``params:`` -> ParamSites.

    ``shared`` entries are reusable templates referenced by name from the
    ``distribution`` field of other tiers; locals may only inherit from shared.
    """
    shared = dict(params_dict.get("shared", {}) or {})

    def resolve(spec):
        dist = spec.get("distribution")
        if isinstance(dist, str) and dist in shared:
            return shared[dist]
        return spec

    def tier_sites(keyword, tier, allow_conditioning):
        out = []
        tier_dict = params_dict.get(keyword)
        if tier_dict is None:
            return out, None
        conditioning = None
        if "conditioning" in tier_dict:
            if not allow_conditioning:
                raise ValueError("%s params cannot have conditioning" % keyword)
            conditioning = tier_dict["conditioning"]
            if conditioning and conditioning.get("species"):
                raise ValueError("cannot condition on species")
        elif keyword == "global_conditioned":
            raise ValueError("global_conditioned MUST have conditioning")
        for k, v in tier_dict.items():
            if k == "conditioning":
                continue
            if keyword == "constant":
                site = Site(k, tier=tier, kind=CONSTANT, init_mu=float(v))
            else:
                if keyword == "local" and isinstance(v.get("distribution"), str):
                    dist = v["distribution"]
                    in_g = any(
                        dist == name
                        for name in (params_dict.get("global") or {})
                        if name != "conditioning"
                    )
                    in_gc = any(
                        dist == name
                        for name in (params_dict.get("global_conditioned") or {})
                        if name != "conditioning"
                    )
                    if (in_g or in_gc) and dist not in shared:
                        raise ValueError("locals can only inherit from shared")
                site = _site_from_spec(k, resolve(v), tier, conditioning)
            if site is not None:
                out.append(site)
        return out, conditioning

    local, _ = tier_sites("local", "local", True)
    global_cond, _ = tier_sites("global_conditioned", "global_cond", True)
    global_, _ = tier_sites("global", "global", False)
    constant, _ = tier_sites("constant", "constant", False)
    return ParamSites(local, global_cond, global_, constant)
