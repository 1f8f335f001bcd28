from .ops import (csd_expand, csd_expand_stack, csd_matvec,  # noqa: F401
                  csd_qsweep, exp2_int, paged_attention, paged_gather,
                  quantize_pot)
