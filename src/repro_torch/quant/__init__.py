from .ptq import (dequant, pack_int4, quant_bytes,  # noqa: F401
                  quantize_tree, serving_quant, unpack_int4)
