"""Model zoo registry: the JAX package's 17 models.  The ``dr``, ``relay``
and ``degrader`` families and ``dr_blackbox`` have fused kernels under
``solver: pallas_<method>``; the others (``debug``, ``auto``, ``prpr``,
``inducer``, ``dr_growthrate``) take the generic solver under any solver."""

from vihds_tpu_torch.models import (
    auto_constant,
    debug,
    degrader_constant,
    dr_blackbox,
    dr_constant,
    dr_growthrate,
    inducer_constant,
    prpr_constant,
    relay_constant,
)

LOOKUP = {
    "debug_constant": debug.Debug_Constant,
    "auto_constant": auto_constant.Auto_Constant,
    "auto_constant_precisions": auto_constant.Auto_Constant_Precisions,
    "degrader_constant": degrader_constant.Degrader_Constant,
    "degrader_constant_precisions": degrader_constant.Degrader_Constant_Precisions,
    "dr_constant": dr_constant.DR_Constant,
    "dr_constant_v2": dr_constant.DR_Constant_V2,
    "dr_constant_precisions": dr_constant.DR_Constant_Precisions,
    "dr_constant_precisions_v2": dr_constant.DR_Constant_Precisions_V2,
    "dr_blackbox": dr_blackbox.DR_Blackbox,
    "dr_growthrate": dr_growthrate.DR_Growthrate,
    "inducer_constant": inducer_constant.Inducer_Constant,
    "inducer_constant_precisions": inducer_constant.Inducer_Constant_Precisions,
    "prpr_constant": prpr_constant.PRPR_Constant,
    "prpr_constant_precisions": prpr_constant.PRPR_Constant_Precisions,
    "relay_constant": relay_constant.Relay_Constant,
    "relay_constant_precisions": relay_constant.Relay_Constant_Precisions,
}
