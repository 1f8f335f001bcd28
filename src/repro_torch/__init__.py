"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``src/repro/`` one for one, so each ported file names
its reference.  Two slices are ported.  The serving path: the dense LM
zoo member qwen2-0.5b, int8 power-of-two weight quantization, the
block-paged KV cache and the paged serving engine, with the paged KV gather
and the fused paged decode attention as hand-written CUDA kernels.  The
paper's search and tuning path: the pendigits surrogate, the ZAAL float
trainer, the Section IV-A min-q search on the sweep evaluator and the IV-B
CSD-digit tuner on the mutation evaluator, with the two CSD digit-plane
shift-add kernels in CUDA.  The kernels' sources are in
``repro_torch/kernels/csrc``.  The package imports ``torch`` and never
``jax`` or ``repro``; the tests hold it against ``repro`` on the CPU.
"""
