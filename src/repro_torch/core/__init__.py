"""The paper's hardware-aware post-training quantization and tuning of
feedforward ANNs (counterpart of ``repro/core``): CSD arithmetic, the
integer MLP oracle, the shift-add synthesis planner, the Section IV-A
min-q search, the IV-B CSD-digit and IV-C smallest-left-shift tuners, the
Section III/V architecture pricing and the Section VI CAD tool SIMURG."""
from . import (archs, csd, hwmodel, intmlp, mcm, planner,  # noqa: F401
               quantize, simurg, tuning)
from .intmlp import IntMLP, forward_int, hardware_accuracy, quantize_inputs  # noqa: F401
from .quantize import find_min_q, quantize_mlp, quantize_value  # noqa: F401
from .tuning import tune_parallel, tune_time_multiplexed  # noqa: F401
