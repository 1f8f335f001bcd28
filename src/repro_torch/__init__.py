"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``src/repro/`` one for one, so each ported file names
its reference.  The serving path: the dense LM zoo member qwen2-0.5b,
int8 power-of-two weight quantization, the block-paged KV cache and the
paged serving engine, with the paged KV gather and the fused paged decode
attention as hand-written CUDA kernels.  The paper's pipeline: the
pendigits surrogate, the ZAAL float trainer, the Section IV-A min-q search
on the sweep evaluator, the IV-B CSD-digit and IV-C smallest-left-shift
tuners on the mutation evaluator, the Section III/V architecture pricing,
the Section VI CAD tool SIMURG and the design-space explorer, with the two
CSD digit-plane shift-add kernels in CUDA.  The LM-scale quantization
path and the hybrid family, with the flash-attention and linear-scan
kernels in CUDA.  The kernels' sources are in
``repro_torch/kernels/csrc``.  The package imports ``torch`` and never
``jax`` or ``repro``; the tests hold it against ``repro`` on the CPU.
"""
