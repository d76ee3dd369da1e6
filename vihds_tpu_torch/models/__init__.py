"""Model zoo registry.  Only the models whose path is ported are listed; the
rest of the JAX package's zoo comes in later slices (ROADMAP queue 1,
item 9)."""

from vihds_tpu_torch.models import dr_constant

LOOKUP = {
    "dr_constant": dr_constant.DR_Constant,
    "dr_constant_v2": dr_constant.DR_Constant_V2,
    "dr_constant_precisions": dr_constant.DR_Constant_Precisions,
    "dr_constant_precisions_v2": dr_constant.DR_Constant_Precisions_V2,
}
