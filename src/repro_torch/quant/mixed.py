"""The serving-cost pricing of an integer MLP, from ``repro/quant/mixed.py``.

Only :func:`intmlp_serving_sheet` (with its ``_effective_bits``) is here:
the design-space explorer prices every point's ``weight_bytes`` through
it.  The per-matmul mixed-bitwidth searches of the reference module
(``mixed_bitwidth_search``, ``mixed_minq_search``) are not ported yet
(ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hwmodel import ServingCostSheet
from repro_torch.core.intmlp import IntMLP

__all__ = ["intmlp_serving_sheet"]


def _effective_bits(w, b) -> int:
    """Sign-magnitude bits of a layer after normalizing the common trailing
    zeros (which is exactly the embedding shift for mixed layers)."""
    vals = np.concatenate([np.abs(np.asarray(w)).ravel(),
                           np.abs(np.asarray(b)).ravel()])
    m = int(vals.max(initial=0))
    if m == 0:
        return 1
    nz = vals[vals > 0]
    tz = min(int(v) & -int(v) for v in nz).bit_length() - 1
    return 1 + (m >> tz).bit_length()


def intmlp_serving_sheet(mlp: IntMLP, *, act_itemsize: float = 1.0,
                         meta: dict | None = None) -> ServingCostSheet:
    """Price an (optionally mixed) ``IntMLP`` as a serving ledger: per-layer
    effective bits after trailing-zero normalization, so a layer embedded at
    ``q*`` but quantized at ``qk < q*`` prices at its native width."""
    sheet = ServingCostSheet(meta=dict(meta or {}))
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        bits = _effective_bits(w, b)
        sheet.add_layer(f"layer{i}", bits=bits, k=int(w.shape[0]),
                        n=int(w.shape[1]), act_itemsize=act_itemsize)
        sheet.extra_bytes += b.size * bits / 8.0       # bias at layer width
    return sheet
