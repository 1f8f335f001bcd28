"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``src/repro/`` one for one, so each ported file names
its reference.  This slice carries the serving path: the dense LM zoo
member qwen2-0.5b, int8 power-of-two weight quantization, the block-paged
KV cache and the paged serving engine, with the paged KV gather and the
fused paged decode attention as hand-written CUDA kernels
(``repro_torch/kernels/csrc``).  The package imports ``torch`` and never
``jax`` or ``repro``; the tests hold it against ``repro`` on the CPU.
"""
