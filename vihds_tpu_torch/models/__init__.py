"""Model zoo registry.  Only the models whose path is ported are listed; the
rest of the JAX package's zoo comes in later slices (ROADMAP queue 1, "The
rest of the model zoo").  No shipped spec names ``relay_constant`` or
``degrader_constant`` (their ``prec_*`` sites are in no spec); they are
registered as the JAX package registers them."""

from vihds_tpu_torch.models import degrader_constant, dr_blackbox, dr_constant, relay_constant

LOOKUP = {
    "degrader_constant": degrader_constant.Degrader_Constant,
    "degrader_constant_precisions": degrader_constant.Degrader_Constant_Precisions,
    "dr_blackbox": dr_blackbox.DR_Blackbox,
    "dr_constant": dr_constant.DR_Constant,
    "dr_constant_v2": dr_constant.DR_Constant_V2,
    "dr_constant_precisions": dr_constant.DR_Constant_Precisions,
    "dr_constant_precisions_v2": dr_constant.DR_Constant_Precisions_V2,
    "relay_constant": relay_constant.Relay_Constant,
    "relay_constant_precisions": relay_constant.Relay_Constant_Precisions,
}
