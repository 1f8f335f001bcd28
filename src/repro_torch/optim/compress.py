"""Gradient compression: per-tensor int8 power-of-two-scale quantization
(counterpart of ``repro/optim/compress.py``).

``pot_compressor`` is the grads -> grads transform ``make_train_step``
takes: each tensor of at least ``min_size`` elements is quantized to
``bits``-bit integers on a power-of-two scale and dequantized, the numbers
a compressed wire format would carry.  The exponent is read exactly off
``frexp`` and the scales are built from exponent bits, as
``ops.quantize_pot`` does, so they are the same on every device; the
reference's XLA CPU ``log2`` floors one low where ``qmax / amax`` is an
exact power of two, and its ``exp2`` is inexact at e = +-13 and below
-14 (``tests/test_torch_train.py`` pins both).  The reference's
``compressed_psum``, a collective, waits for the port's parallelism
(ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import exp2_int
from repro_torch.tree import tree_map

__all__ = ["pot_quantize_dequantize", "pot_compressor"]


def pot_quantize_dequantize(g: torch.Tensor, *, bits: int = 8):
    """Per-tensor PoT-scale int quantize -> dequantize, in g's dtype."""
    g32 = g.float()
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.amax(torch.abs(g32))
    _, e = torch.frexp(qmax / torch.clamp(amax, min=1e-30))
    exp = torch.clamp(e - 1, -126, 126)                 # floor(log2(.))
    q = torch.clamp(torch.round(g32 * exp2_int(exp)), -qmax - 1, qmax)
    return (q * exp2_int(-exp)).to(g.dtype)


def pot_compressor(*, bits: int = 8, min_size: int = 4096):
    """grads -> grads; tensors smaller than ``min_size`` pass through
    (norms and biases: few bytes, and accuracy-critical)."""
    def compress(grads):
        return tree_map(lambda g: pot_quantize_dequantize(g, bits=bits)
                        if g.numel() >= min_size else g, grads)
    return compress
