from .ptq import (dequant, min_bitwidth_search, pack_int4,  # noqa: F401
                  quant_bytes, quantizable_paths, quantize_tree,
                  serving_ledger, serving_quant, sls_rescale, unpack_int4)
from .mixed import (MixedBitwidthResult, MixedQResult,  # noqa: F401
                    intmlp_serving_sheet, mixed_bitwidth_search,
                    mixed_minq_search)
