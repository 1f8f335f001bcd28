"""The paper's hardware-aware post-training quantization and tuning of
feedforward ANNs (counterpart of ``repro/core``): CSD arithmetic, the
integer MLP oracle, the shift-add synthesis planner, the Section IV-A
min-q search and the IV-B CSD-digit tuner."""
from . import csd, intmlp, mcm, planner, quantize, tuning  # noqa: F401
from .intmlp import IntMLP, forward_int, hardware_accuracy, quantize_inputs  # noqa: F401
from .quantize import find_min_q, quantize_mlp, quantize_value  # noqa: F401
from .tuning import tune_parallel  # noqa: F401
