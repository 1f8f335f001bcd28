from .ops import (chain_scan, csd_expand, csd_expand_stack,  # noqa: F401
                  csd_matvec, csd_qsweep, exp2_int, flash_attention,
                  linear_scan, paged_attention, paged_gather,
                  paged_gather_pair, qmatmul, quantize_pot, tm_chain,
                  wkv6)
