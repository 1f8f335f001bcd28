"""Post-training quantization for the LM zoo -- the paper's pipeline at
scale (counterpart of ``repro/quant/ptq.py``).

1. ``quantize_tree`` -- per-channel power-of-two-scale int8 (or
   nibble-packed int4) quantization of the matmul weights, the paper's 2^q
   conversion per output channel.  Norm scales, biases and other small
   leaves stay float; ``dequant`` reconstructs the float weights exactly.
2. ``min_bitwidth_search`` -- the paper's minimum-quantization-value loop
   (IV-A) with the LM metric: walk down the bit ladder while the loss on a
   validation batch stays within a relative budget.
3. ``sls_rescale`` -- the smallest-left-shift tuning (IV-C analogue), PoT
   form: raise each matmul's shared exponents while the budget holds.
4. ``serving_ledger`` -- the serving cost sheet of a (params, bits) pair.
5. ``quantizable_paths`` -- the matmul weights ``quantize_tree`` would
   quantize: the mixed bit-width search's layer list.

Leaves are visited in the reference's tree order (dict keys sorted, a
qleaf whole), and named by the reference's path strings
(``"layers/attn/wq"``), so the rescale's greedy walk and the ledger's rows
come in the reference's order.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.core.hwmodel import ServingCostSheet
from repro_torch.kernels.ops import exp2_int, quantize_pot

__all__ = ["quantize_tree", "dequant", "min_bitwidth_search", "sls_rescale",
           "quant_bytes", "pack_int4", "unpack_int4", "serving_quant",
           "quantizable_paths", "serving_ledger"]

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
    """``fn(path, leaf)`` over a tree of dicts and lists; a list item's
    path part is ``[i]``, as the reference's key paths print it."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (f"[{i}]",))
                for i, v in enumerate(tree)]
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
    if isinstance(tree, list):
        return [_map_qleaves(fn, v) for v in tree]
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


def _flatten(tree, path=()):
    """(path tuple, leaf) pairs in the reference's tree order: dict keys
    sorted, a qleaf kept whole."""
    if isinstance(tree, dict) and not _is_qleaf(tree):
        return [item for key in sorted(tree)
                for item in _flatten(tree[key], path + (key,))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + (f"[{i}]",))]
    return [(path, tree)]


def quantizable_paths(params) -> list:
    """Path strings of the matmul weights :func:`quantize_tree` would
    quantize, in the reference's tree order (dict keys sorted) -- the
    mixed bit-width search's layer list, whose greedy core breaks ties by
    the first index."""
    keys = (("/".join(path), leaf) for path, leaf in _flatten(params))
    return [key for key, leaf in keys
            if torch.is_tensor(leaf) and _should_quantize(key, leaf)]


def _with_leaf(tree, path, leaf):
    """A copy of ``tree`` with the leaf at ``path`` replaced (the dicts on
    the path are copied, everything else is shared)."""
    if not path:
        return leaf
    out = dict(tree)
    out[path[0]] = _with_leaf(tree[path[0]], path[1:], leaf)
    return out


def serving_ledger(params, *, bits=8, act_itemsize: float = 2.0,
                   meta: dict | None = None) -> ServingCostSheet:
    """Price a (params, bits) pair as a :class:`~repro_torch.core.hwmodel.
    ServingCostSheet`: weight bytes at each matmul's rung, activation bytes
    and int-ops per token, roofline intensity.

    Weight bytes are priced at the LOGICAL bitwidth (size * bits / 8 plus
    the per-channel int32 scale); unquantized leaves (norms, biases) land
    in ``extra_bytes``.  Rows are named by the reference's path strings and
    come in its order, so ``to_dict()`` equals the reference's."""
    sheet = ServingCostSheet(meta=dict(meta or {}))
    extra = 0.0
    for path, leaf in _flatten(params):
        key = "/".join(path)
        if not _should_quantize(key, leaf):
            extra += leaf.numel() * leaf.element_size()
            continue
        n = int(leaf.shape[-1])
        sheet.add_layer(key, bits=_bits_for(bits, key),
                        k=int(leaf.shape[-2]), n=n, size=int(leaf.numel()),
                        scale_bytes=4.0 * n, act_itemsize=act_itemsize)
    sheet.extra_bytes = extra
    if not isinstance(bits, int):
        sheet.meta.setdefault("bits", {k: _bits_for(bits, k)
                                       for k in sheet.bits_by_layer()})
    return sheet


def _eval_many_default(eval_fn):
    """Scorer for an iterable of same-structure trees: ``eval_fn`` on each
    in turn.  The reference stacks the trees under one ``lax.map``
    dispatch, which gives the same per-tree losses; here each tree is
    scored as it comes, so a lazy iterable keeps one dequantized copy
    alive at a time."""
    def eval_many(trees):
        return [eval_fn(t) for t in trees]
    return eval_many


def min_bitwidth_search(params, eval_fn, *, budget: float = 0.01,
                        bit_ladder=(8, 6, 5, 4), engine: str = "batched",
                        eval_many=None) -> tuple:
    """Paper IV-A at LM scale: walk down the bit ladder while quality holds.

    ``eval_fn(float_tree) -> scalar loss`` (lower is better).  Returns
    (quantized tree, chosen bits, history); the budget is a relative loss
    increase over the float baseline.

    ``engine="batched"`` quantizes every rung once, scores them all
    through ``eval_many`` (default: :func:`_eval_many_default`; it receives
    an iterable of dequantized trees, made one at a time) and then walks
    the per-rung losses with the serial stopping rule; ``engine="serial"``
    is the quantize-score-break loop.  Both return the same
    ``(tree, bits, history)``."""
    if engine not in ("batched", "serial"):
        raise ValueError(engine)
    base = float(eval_fn(params))
    history = [("float", base)]
    chosen, bits_used = None, None
    if engine == "serial":
        for bits in bit_ladder:
            qt = quantize_tree(params, bits=bits)
            loss = float(eval_fn(dequant(qt)))
            history.append((bits, loss))
            if loss <= base * (1.0 + budget):
                chosen, bits_used = qt, bits
            else:
                break
        if chosen is None:                # even the first rung broke it
            chosen, bits_used = quantize_tree(params, bits=bit_ladder[0]), \
                bit_ladder[0]
        return chosen, bits_used, history
    qts = [quantize_tree(params, bits=b) for b in bit_ladder]
    if eval_many is None:
        eval_many = _eval_many_default(eval_fn)
    losses = [float(x) for x in eval_many(dequant(qt) for qt in qts)]
    for bits, qt, loss in zip(bit_ladder, qts, losses):  # serial stopping
        history.append((bits, loss))                     # walk
        if loss <= base * (1.0 + budget):
            chosen, bits_used = qt, bits
        else:
            break                    # deeper rungs scored but never visited
    if chosen is None:
        chosen, bits_used = qts[0], bit_ladder[0]
    return chosen, bits_used, history


def sls_rescale(qtree, eval_fn, *, budget: float = 0.01, max_raise: int = 2):
    """Paper IV-C analogue: raise shared PoT exponents (coarser grids) while
    the budget holds.  Raising a leaf's exponent by k zeroes the k LSBs of
    every mantissa in it -- the paper's 'multiple of 2^k' narrowing.  The
    qleaves are tried in the reference's order, greedily, k = 1 ..
    ``max_raise`` each until one breaks the budget.  Returns (tree, number
    of raises kept)."""
    base = float(eval_fn(dequant(qtree)))
    raised = 0
    tree = qtree
    for path, leaf in _flatten(qtree):
        if not _is_qleaf(leaf):
            continue
        packed = leaf.get("packed")
        for k in range(1, max_raise + 1):
            cand = dict(leaf)
            mant = unpack_int4(leaf["q"]) if packed else leaf["q"]
            mant = ((mant.to(torch.int32) >> k) << k).to(torch.int8)
            cand["q"] = pack_int4(mant) if packed else mant
            trial = _with_leaf(tree, path, cand)
            if float(eval_fn(dequant(trial))) <= base * (1.0 + budget):
                tree = trial
                raised += 1
            else:
                break
    return tree, raised
