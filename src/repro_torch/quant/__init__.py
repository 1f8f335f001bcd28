from .ptq import (dequant, min_bitwidth_search, pack_int4,  # noqa: F401
                  quant_bytes, quantize_tree, serving_ledger, serving_quant,
                  sls_rescale, unpack_int4)
from .mixed import intmlp_serving_sheet  # noqa: F401
