from .ops import (csd_expand, csd_expand_stack, csd_matvec,  # noqa: F401
                  csd_qsweep, exp2_int, flash_attention, linear_scan,
                  paged_attention, paged_gather, paged_gather_pair, qmatmul,
                  quantize_pot)
