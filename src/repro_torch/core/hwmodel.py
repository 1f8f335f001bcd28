"""Serving cost ledger (counterpart of the serving part of
``repro/core/hwmodel.py``).

Where the reference's ``CostSheet`` prices an ASIC realization (area,
delay, energy of adders and multipliers), ``ServingCostSheet`` prices the
same network as a serving artifact: resident weight bytes at each layer's
searched bitwidth, activation bytes moved per token, int-ops per token,
and the roofline arithmetic intensity those imply.  The totals add the
rows with builtin ``sum`` in layer order, as the reference does, so
``to_dict()`` equals the reference's bit for bit under the same Python.
The ASIC pricing waits for the pricing slice.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

__all__ = ["ServingLayerCost", "ServingCostSheet"]


@dataclass(frozen=True)
class ServingLayerCost:
    """One matmul's serving ledger row, priced from its searched bitwidth.

    ``k``/``n`` are the contraction and output sizes of one token's matvec;
    ``mults`` the number of weight elements applied per token (``size`` —
    equal to k*n for a plain matrix, and to the full element count for
    stacked/scanned weights whose every element multiplies once per token).
    """
    name: str
    bits: int              # weight bitwidth (the searched rung)
    k: int                 # contraction dim of one token's matvec
    n: int                 # output channels (scale count)
    size: int              # weight elements (k * n * stacked copies)
    scale_bytes: float     # per-channel scale/exponent overhead
    act_itemsize: float    # activation bytes per element

    @property
    def weight_bytes(self) -> float:
        """Resident mantissa bytes at ``bits`` + the scale overhead."""
        return self.size * self.bits / 8.0 + self.scale_bytes

    @property
    def copies(self) -> int:
        """Stacked applications per token (scanned layer weights carry the
        layer count in their leading dims: size = copies * k * n)."""
        return max(1, self.size // (self.k * self.n))

    @property
    def act_bytes(self) -> float:
        """Activation bytes moved per token (read k, write n, per copy)."""
        return self.copies * (self.k + self.n) * self.act_itemsize

    @property
    def ops_per_token(self) -> float:
        """Multiply-accumulate ops per token (2 ops per weight element)."""
        return 2.0 * self.size

    def to_dict(self) -> dict:
        return asdict(self)


class ServingCostSheet:
    """Per-layer serving-cost ledger of a (possibly mixed-bitwidth) network.

    Rows are :class:`ServingLayerCost` entries in layer order; ``extra_bytes``
    carries the unquantized residue (norm scales, biases, routers) so
    ``total_bytes`` is the true resident footprint.  ``save``/``load``
    round-trip exactly through JSON (floats survive bit-for-bit: json emits
    ``repr`` floats and Python parses them back to the same doubles), which
    the property suite pins.
    """

    def __init__(self, layers=None, *, extra_bytes: float = 0.0,
                 meta: dict | None = None):
        self.layers: list[ServingLayerCost] = list(layers or [])
        self.extra_bytes = float(extra_bytes)
        self.meta = dict(meta or {})

    def add_layer(self, name: str, *, bits: int, k: int, n: int,
                  size: int | None = None, scale_bytes: float = 0.0,
                  act_itemsize: float = 1.0) -> ServingLayerCost:
        row = ServingLayerCost(
            name=name, bits=int(bits), k=int(k), n=int(n),
            size=int(k * n if size is None else size),
            scale_bytes=float(scale_bytes), act_itemsize=float(act_itemsize))
        self.layers.append(row)
        return row

    # -- totals ------------------------------------------------------------

    def weight_bytes(self) -> float:
        return sum(r.weight_bytes for r in self.layers)

    def act_bytes(self) -> float:
        return sum(r.act_bytes for r in self.layers)

    def ops_per_token(self) -> float:
        return sum(r.ops_per_token for r in self.layers)

    def total_bytes(self) -> float:
        """Resident footprint: quantized layers + unquantized residue."""
        return self.weight_bytes() + self.extra_bytes

    def bytes_per_token(self) -> float:
        """Bytes a decode step moves: every resident weight byte (weights
        stream from HBM once per token) plus the layer activations."""
        return self.total_bytes() + self.act_bytes()

    def arithmetic_intensity(self) -> float:
        """Roofline AI of one decode token: ops / bytes moved."""
        b = self.bytes_per_token()
        return self.ops_per_token() / b if b > 0 else 0.0

    def bits_by_layer(self) -> dict:
        return {r.name: r.bits for r in self.layers}

    # -- JSON round-trip (the FlopCount idiom) -----------------------------

    def to_dict(self) -> dict:
        return {"layers": [r.to_dict() for r in self.layers],
                "extra_bytes": self.extra_bytes, "meta": self.meta,
                "totals": {"weight_bytes": self.weight_bytes(),
                           "act_bytes": self.act_bytes(),
                           "ops_per_token": self.ops_per_token(),
                           "total_bytes": self.total_bytes(),
                           "arithmetic_intensity":
                               self.arithmetic_intensity()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ServingCostSheet":
        return cls([ServingLayerCost(**r) for r in d["layers"]],
                   extra_bytes=d.get("extra_bytes", 0.0),
                   meta=d.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @staticmethod
    def load(path: str) -> "ServingCostSheet":
        with open(path) as f:
            return ServingCostSheet.from_dict(json.load(f))

    def __len__(self) -> int:
        return len(self.layers)

    def row_strs(self) -> list:
        return [f"{r.name:24s} bits={r.bits:2d} "
                f"wbytes={r.weight_bytes:12.1f} ops/tok={r.ops_per_token:12.0f}"
                for r in self.layers]
