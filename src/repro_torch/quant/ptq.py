"""Post-training quantization for serving (counterpart of the serving part
of ``repro/quant/ptq.py``).

Per-channel power-of-two-scale int8 (or nibble-packed int4) quantization
of the matmul weights -- the paper's 2^q conversion, per output channel.
Norm scales, biases and other small leaves stay float.  ``dequant``
reconstructs the float weights exactly (the scale is a power of two).
``serving_ledger`` and the bit-width searches are not ported yet.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.kernels.ops import exp2_int, quantize_pot

__all__ = ["quantize_tree", "dequant", "quant_bytes", "pack_int4",
           "unpack_int4", "serving_quant"]

_SKIP_SUBSTR = ("ln", "norm", "router", "gate_i", "gate_r", "lam", "mu",
                "u", "w0", "bias", "bq", "bk", "bv")


def _should_quantize(path_key: str, leaf) -> bool:
    if leaf.ndim < 2:
        return False
    name = path_key.split("/")[-1]
    return not any(s in name for s in _SKIP_SUBSTR)


def pack_int4(q_i8: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (stored in int8) two per byte along the last dim:
    the even element in the low nibble, the odd one in the high nibble."""
    if q_i8.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even last dim")
    lo = q_i8[..., 0::2].to(torch.int32) & 0x0F
    hi = (q_i8[..., 1::2].to(torch.int32) & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extends each nibble)."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28                         # arithmetic sign-extend
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def _bits_for(bits, key: str) -> int:
    """Resolve an int-or-Mapping ``bits`` spec for one leaf path; paths a
    Mapping does not name stay at 8 bits."""
    if isinstance(bits, Mapping):
        return int(bits.get(key, 8))
    return int(bits)


def _quantize_leaf(leaf: torch.Tensor, b: int) -> dict:
    """One matmul weight -> PoT qleaf dict at ``b`` bits (nibble-packed when
    b <= 4 and the last dim is even)."""
    axis = tuple(range(leaf.ndim - 1))         # per output channel
    wq, e = quantize_pot(leaf.to(torch.float32), bits=b, axis=axis)
    if b <= 4 and leaf.shape[-1] % 2 == 0:
        return {"q": pack_int4(wq), "exp": e, "bits": b, "packed": True}
    return {"q": wq, "exp": e, "bits": b}


def quantize_tree(params, *, bits=8):
    """Replace big matmul weights by {"q": int8, "exp": int32, "bits"}
    dicts (int4 mantissas nibble-packed).  ``bits`` is one global rung or
    a ``{path: bits}`` Mapping; every qleaf carries its own scheme."""
    def q(key, leaf):
        if not torch.is_tensor(leaf) or not _should_quantize(key, leaf):
            return leaf
        return _quantize_leaf(leaf, _bits_for(bits, key))
    return _map_with_path(q, params)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) >= {"q", "exp"}


def _map_qleaves(fn, tree):
    if _is_qleaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_qleaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def dequant(qtree, dtype=torch.bfloat16):
    """Reconstruct a float parameter tree: q * 2^-exp, exact, in
    ``dtype`` (float leaves pass through)."""
    def d(leaf):
        if not _is_qleaf(leaf):
            return leaf
        q = unpack_int4(leaf["q"]) if leaf.get("packed") else leaf["q"]
        return (q.to(torch.float32) * exp2_int(-leaf["exp"])).to(dtype)
    return _map_qleaves(d, qtree)


def quant_bytes(tree) -> int:
    """Serving bytes of a (possibly quantized) tree."""
    total = 0

    def add(leaf):
        nonlocal total
        if _is_qleaf(leaf):
            total += leaf["q"].numel() + leaf["exp"].numel() * 4
        elif torch.is_tensor(leaf):
            total += leaf.numel() * leaf.element_size()
        return leaf
    _map_qleaves(add, tree)
    return total


def serving_quant(params, *, bits=8, dtype=torch.bfloat16):
    """Serve-side hook: quantize once, return the resident representation.

    Returns ``(qtree, deq, resident_bytes)``: the int8-PoT (or packed int4)
    tree the engine keeps on the device, the closure the engine calls
    inside each prefill/decode dispatch (exact dequant to ``dtype``), and
    the serving footprint (:func:`quant_bytes`)."""
    qt = quantize_tree(params, bits=bits)

    def deq(tree):
        return dequant(tree, dtype=dtype)

    return qt, deq, quant_bytes(qt)
