"""Double-receiver device with growth-rate-coupled expression
(``vihds_tpu.models.dr_growthrate`` in PyTorch, the JAX package's
reconstruction of a model that the shipped spec names).

The 8-species double-receiver mechanics of ``dr_constant``, with every
production term ``rc * a_*`` scaled by the capacity

    cap(t) = es + (1 - es) * clip(sigmoid(4 (t - tlag)) (1 - x/K), 0, 1)

where ``es`` (the spec's extra global) is the expression at zero growth.

No fused kernel computes this right-hand side (the ``dr`` kernels have no
``es``), so the model takes the generic solver under every solver, a
``pallas_<method>`` one included: ``pallas_kinds`` is None.
"""

import torch

from vihds_tpu_torch.models.dr_constant import DR_Constant, _dr_constants, _dr_species_rhs


class DR_Growthrate(DR_Constant):
    version = 1
    pallas_kinds = None

    def make_rhs(self, params, theta, treatments, dev_1hot):
        c = dict(_dr_constants(theta, treatments, self.version))
        es = torch.clamp(theta["es"], 0.0, 1.0)
        prec_params = params.get("precisions", {})
        dynamic = self.precisions.dynamic

        def rhs(t, state):
            x = state[..., 0]
            gnorm = torch.clamp(
                torch.sigmoid(4.0 * (t - c["tlag"])) * (1.0 - x / c["K"]), 0.0, 1.0
            )
            # scaling rc scales every production term of _dr_species_rhs;
            # dilution and degradation stay as they are
            ct = dict(c)
            ct["rc"] = c["rc"] * (es + (1.0 - es) * gnorm)
            dX = _dr_species_rhs(ct, t, state)
            if dynamic:
                dV = self.precisions.rhs(prec_params, t, state, None)
                return torch.cat([dX, dV], dim=-1)
            return dX

        return rhs
