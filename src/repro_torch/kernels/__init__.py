from .ops import (exp2_int, paged_attention, paged_gather,  # noqa: F401
                  quantize_pot)
