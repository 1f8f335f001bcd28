"""Gate-level hardware cost model and serving cost ledger (counterpart of
``repro/core/hwmodel.py``).

Prices the design architectures of Section III analytically, the way the
paper's synthesis flow (Cadence RTL Compiler + TSMC 40nm) does: consistent
per-bit constants for adders, array multipliers, muxes and registers, in
um^2 (area), ns (delay) and fJ (energy per operation).  The absolute
numbers are model constants (DESIGN.md 2); the paper's claims are relative.

Three pricing surfaces live here (DESIGN.md 12.1, 14.2):

* the scalar primitives (``adder`` / ``multiplier`` / ...): one
  :class:`Primitive` per block instance;
* the cost IR: :class:`CostSheet`, a ledger whose entries carry whole
  arrays of area/energy addends (priced by the ``*_vec`` twins) and
  per-kind unit tallies.  Folding is numpy's sequential ``np.cumsum``, the
  left-to-right rounding chain of a scalar ``total += p.area`` loop (not
  pairwise ``np.sum``, nor ``torch.cumsum`` / ``torch.sum``), so every
  total equals the reference's bit for bit;
* ``ServingCostSheet``: the same network priced as a serving artifact,
  resident weight bytes at each layer's searched bitwidth, activation
  bytes moved per token, int-ops per token, and the roofline arithmetic
  intensity those imply.  Its totals add the rows with builtin ``sum`` in
  layer order, as the reference does, so ``to_dict()`` equals the
  reference's under the same Python.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

import numpy as np

__all__ = ["Tech", "TECH40", "adder", "multiplier", "mux", "register",
           "counter", "activation_unit", "acc_bits", "Primitive",
           "CostEntry", "CostSheet", "adder_vec", "multiplier_vec",
           "mux_vec", "register_vec", "ServingLayerCost",
           "ServingCostSheet"]


@dataclass(frozen=True)
class Tech:
    a_fa: float = 4.3        # um^2 per full-adder bit
    a_reg: float = 5.1       # um^2 per register bit
    a_mux2: float = 1.6      # um^2 per 2:1 mux bit
    a_act: float = 2.0       # um^2 per bit of clamp/shift activation logic
    d_fa: float = 0.045      # ns per ripple-carry bit
    d_mux: float = 0.03      # ns per mux stage
    d_reg: float = 0.08      # ns clk->q + setup
    e_fa: float = 1.9        # fJ per full-adder bit toggle
    e_reg: float = 2.4       # fJ per register bit toggle
    e_mux2: float = 0.5      # fJ per mux bit
    activity: float = 0.5    # average switching activity factor
    leak_uw_per_um2: float = 0.004  # static power density (uW / um^2)


TECH40 = Tech()


@dataclass
class Primitive:
    """Area/delay/energy of one hardware block instance."""
    area: float
    delay: float
    energy: float  # dynamic energy per use (fJ), already activity-scaled

    def __add__(self, other: "Primitive") -> "Primitive":
        return Primitive(self.area + other.area,
                         max(self.delay, other.delay),
                         self.energy + other.energy)


def adder(bits: int, tech: Tech = TECH40) -> Primitive:
    """Two-operand ripple adder/subtractor of ``bits`` result bits."""
    bits = max(1, int(bits))
    return Primitive(area=bits * tech.a_fa,
                     delay=bits * tech.d_fa,
                     energy=bits * tech.e_fa * tech.activity)


def multiplier(bits_a: int, bits_b: int, tech: Tech = TECH40) -> Primitive:
    """Array multiplier: bits_a x bits_b partial-product grid."""
    ba, bb = max(1, int(bits_a)), max(1, int(bits_b))
    return Primitive(area=ba * bb * tech.a_fa * 0.95,
                     delay=(ba + bb) * tech.d_fa,
                     energy=ba * bb * tech.e_fa * tech.activity)


def mux(n_inputs: int, bits: int, tech: Tech = TECH40) -> Primitive:
    """n:1 mux as a tree of 2:1 muxes."""
    n = max(1, int(n_inputs))
    stages = int(np.ceil(np.log2(n))) if n > 1 else 0
    return Primitive(area=(n - 1) * bits * tech.a_mux2,
                     delay=stages * tech.d_mux,
                     energy=(n - 1) * bits * tech.e_mux2 * tech.activity)


def register(bits: int, tech: Tech = TECH40) -> Primitive:
    return Primitive(area=bits * tech.a_reg,
                     delay=tech.d_reg,
                     energy=bits * tech.e_reg * tech.activity)


def counter(bits: int, tech: Tech = TECH40) -> Primitive:
    """Counter = register + incrementer."""
    r, a = register(bits, tech), adder(bits, tech)
    return Primitive(r.area + a.area, a.delay + r.delay, r.energy + a.energy)


def activation_unit(bits: int, tech: Tech = TECH40) -> Primitive:
    """hsig/htanh/satlin clamp+shift datapath."""
    bits = max(1, int(bits))
    return Primitive(area=bits * tech.a_act,
                     delay=2 * tech.d_mux,
                     energy=bits * tech.e_mux2 * tech.activity)


def acc_bits(n_terms: int, bits_x: int, bits_w: int) -> int:
    """Accumulator bitwidth for sum of n products of (bits_x x bits_w) ints."""
    return bits_x + bits_w + int(np.ceil(np.log2(max(2, n_terms))))


# ---------------------------------------------------------------------------
# Cost IR: array pricing + the CostSheet ledger (DESIGN.md 12.1)
# ---------------------------------------------------------------------------
#
# The *_vec twins price whole integer arrays of operand widths at once.  Each
# reproduces its scalar primitive's arithmetic **per element, in the same
# operation order**, so every addend is the bit-exact float the scalar
# builder would have accumulated.

def adder_vec(bits, tech: Tech = TECH40):
    """Array twin of :func:`adder`: per-element (area, delay, energy)."""
    b = np.maximum(1, np.asarray(bits, dtype=np.int64))
    return b * tech.a_fa, b * tech.d_fa, b * tech.e_fa * tech.activity


def multiplier_vec(bits_a, bits_b, tech: Tech = TECH40):
    """Array twin of :func:`multiplier` (either operand may be an array)."""
    ba = np.maximum(1, np.asarray(bits_a, dtype=np.int64))
    bb = np.maximum(1, np.asarray(bits_b, dtype=np.int64))
    return (ba * bb * tech.a_fa * 0.95, (ba + bb) * tech.d_fa,
            ba * bb * tech.e_fa * tech.activity)


def mux_vec(n_inputs: int, bits, tech: Tech = TECH40):
    """Array twin of :func:`mux` over an array of bus widths.  The delay
    (a function of the input count alone) comes back as a scalar — adding a
    scalar to an addend array rounds identically to a broadcast array."""
    n = max(1, int(n_inputs))
    stages = int(np.ceil(np.log2(n))) if n > 1 else 0
    b = np.asarray(bits, dtype=np.int64)
    return ((n - 1) * b * tech.a_mux2, stages * tech.d_mux,
            (n - 1) * b * tech.e_mux2 * tech.activity)


def register_vec(bits, tech: Tech = TECH40):
    """Array twin of :func:`register` over an array of register widths
    (scalar delay: clk->q + setup does not depend on the width)."""
    b = np.asarray(bits, dtype=np.int64)
    return b * tech.a_reg, tech.d_reg, b * tech.e_reg * tech.activity


_EMPTY = np.zeros(0, dtype=np.float64)


def _addends(x) -> np.ndarray:
    """Normalize scalar-or-array cost addends to a float64 sequence."""
    if x is None:
        return _EMPTY
    if isinstance(x, np.ndarray):
        if x.dtype == np.float64 and x.ndim == 1:
            return x
        return np.atleast_1d(np.asarray(x, dtype=np.float64)).ravel()
    return np.array((x,), dtype=np.float64)    # scalar fast path


@dataclass
class CostEntry:
    """One ledger line: a run of same-kind component addends, in order."""
    kind: str                  # "mult" | "adder" | "mux" | "register" | ...
    count: int                 # hardware units tallied (n_adders/n_mults)
    area: np.ndarray           # float64 area addends, accumulation order
    energy: np.ndarray         # float64 energy addends, same order
    delay: np.ndarray = field(default_factory=lambda: _EMPTY)


class CostSheet:
    """Typed component ledger over :class:`Primitive` pricing (the cost IR).

    A sheet is an *ordered* list of :class:`CostEntry` rows.  ``fold_area`` /
    ``fold_energy`` reduce the concatenated addend sequence with numpy's
    sequential ``cumsum`` — the exact left-to-right rounding chain a scalar
    ``total += p.area`` loop performs — so array-priced builders reproduce
    the scalar builders' totals to the last bit.  ``max_delay`` folds the
    critical-path candidates by max; ``tally`` sums per-kind unit counts.
    Zero-valued addends are exact no-ops under IEEE addition, so entries may
    carry area without energy (or vice versa) and still fold bit-identically.
    """

    def __init__(self, tech: Tech = TECH40):
        self.tech = tech
        self.entries: list[CostEntry] = []
        self._merged_counts: dict = {}     # tallies folded in via add_sheet

    def add(self, kind: str, *, area=None, energy=None, delay=None,
            count: int = 0) -> None:
        """Append one ledger row of addend sequences (scalars or arrays).
        ``None`` axes contribute nothing (tally-only rows pass counts alone)."""
        self.entries.append(CostEntry(
            kind, int(count), _addends(area), _addends(energy),
            _addends(delay)))

    def add_primitive(self, kind: str, prim: Primitive, n: int = 1,
                      count: int | None = None) -> None:
        """The builders' ``total += p.area * n`` idiom: one addend per axis."""
        self.add(kind, area=prim.area * n, energy=prim.energy * n,
                 delay=prim.delay, count=n if count is None else count)

    def add_sheet(self, other: "CostSheet", kind: str = "subtotal") -> None:
        """Fold ``other`` and append its totals as ONE addend each — the
        ``area += layer_area`` idiom (a rounded sub-accumulation, *not*
        flat concatenation), carrying the child's unit tallies."""
        self.entries.append(CostEntry(
            kind, 0,
            _addends(other.fold_area()), _addends(other.fold_energy()),
            _addends(other.max_delay()) if other._has_delay() else _EMPTY))
        for k, v in other.tally().items():
            self._merged_counts[k] = self._merged_counts.get(k, 0) + v

    # -- folding -----------------------------------------------------------

    @staticmethod
    def _seqfold(parts: list[np.ndarray]) -> float:
        """Exact sequential sum (left-to-right, rounding at each step)."""
        if not parts:
            return 0.0
        seq = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return float(np.cumsum(seq)[-1]) if seq.size else 0.0

    def fold_area(self) -> float:
        return self._seqfold([e.area for e in self.entries])

    def fold_energy(self) -> float:
        return self._seqfold([e.energy for e in self.entries])

    def _has_delay(self) -> bool:
        return any(e.delay.size for e in self.entries)

    def max_delay(self) -> float:
        """Critical-path fold: max over every entry's delay candidates."""
        parts = [e.delay for e in self.entries if e.delay.size]
        return float(max(p.max() for p in parts)) if parts else 0.0

    def tally(self) -> dict:
        """Unit counts by component kind (the DesignReport detail ledger)."""
        out: dict = dict(self._merged_counts)
        for e in self.entries:
            if e.kind != "subtotal" and e.count:
                out[e.kind] = out.get(e.kind, 0) + e.count
        return out

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# Serving cost ledger: bytes / ops per token / roofline intensity
# (DESIGN.md 14.2)
# ---------------------------------------------------------------------------

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
