"""Design architectures (paper Section III) and their cost reports, the
counterpart of ``repro/core/archs.py``.

Three realizations of a quantized :class:`~repro_torch.core.intmlp.IntMLP`:

* ``parallel``     — all neuron computations concurrent (Fig. 4);
* ``smac_neuron``  — one MAC block per neuron, layer-synchronized (Fig. 6),
  cycles = sum_i (iota_i + 1);
* ``smac_ann``     — a single MAC for the whole network (Fig. 7),
  cycles = sum_i (iota_i + 2) * eta_i.

Each supports ``style='behavioral'`` (real multipliers) or a multiplierless
style (Section V): parallel takes ``'cavm'`` (per-neuron shift-add, alg. of
[19]) or ``'cmvm'`` (per-layer shared shift-add, alg. of [18]); SMAC_NEURON
takes ``'mcm'`` (per-layer MCM block feeding the accumulators, Fig. 9).
SMAC_ANN multiplierless is priced too — the paper notes it *increases*
complexity, and the model reproduces that.

Two pricing engines (DESIGN.md 12), host numpy in float64:

* ``engine="array"`` (default) — the cost-IR builders: per-column magnitude
  bitwidths, multiplier/adder tallies, and CSD/planner graph bounds come
  from whole-array ops, priced by the vectorized ``hwmodel.*_vec`` twins
  into a :class:`~repro_torch.core.hwmodel.CostSheet` whose sequential fold
  reproduces the scalar builders' float accumulation exactly;
* ``engine="scalar"`` — the per-scalar builders.  Where the reference's
  SMAC_ANN multiplierless builder adds its per-adder terms with builtin
  ``sum`` (compensated since Python 3.12), this one adds them left to
  right, the accumulation the cost model was pinned with, so both engines
  give the same :class:`DesignReport` numbers (ROADMAP §3).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import csd, hwmodel
from .hwmodel import (TECH40, CostSheet, Primitive, acc_bits, adder,
                      adder_vec, multiplier_vec, mux, mux_vec, register,
                      register_vec)
from .planner import default_planner
from .intmlp import FRAC, IntMLP
from .tuning import sls_of

__all__ = ["DesignReport", "design_cost", "cycle_count", "ARCH_STYLES"]

BITS_X = 8  # layer IO bitwidth (paper Section VII)

#: Every (architecture, style) combination the cost model prices — the
#: design-space axes ``repro_torch.explore`` sweeps.
ARCH_STYLES = (
    ("parallel", "behavioral"), ("parallel", "cavm"), ("parallel", "cmvm"),
    ("smac_neuron", "behavioral"), ("smac_neuron", "mcm"),
    ("smac_ann", "behavioral"), ("smac_ann", "mcm"),
)


@dataclass
class DesignReport:
    arch: str
    style: str
    area_um2: float
    latency_ns: float
    energy_pj: float
    cycles: int
    clock_ns: float
    n_adders: int = 0
    n_mults: int = 0
    detail: dict = field(default_factory=dict)

    def row(self) -> str:
        return (f"{self.arch:12s} {self.style:10s} area={self.area_um2:10.0f}um2 "
                f"lat={self.latency_ns:9.2f}ns energy={self.energy_pj:9.1f}pJ "
                f"cyc={self.cycles:5d} clk={self.clock_ns:5.2f}ns")


def _wbits(values) -> int:
    vals = [abs(int(v)) for v in np.asarray(values).ravel() if int(v) != 0]
    return max((v.bit_length() for v in vals), default=1) + 1  # +1 sign


def _wbits_of_bl(bl: np.ndarray) -> int:
    """:func:`_wbits` from precomputed per-element bit lengths."""
    mx = int(bl.max()) if bl.size else 0
    return (mx if mx > 0 else 1) + 1


def _wbits_array(values) -> int:
    """Whole-array :func:`_wbits`: one signed magnitude bitwidth for a set."""
    return _wbits_of_bl(csd.bit_length_array(values))


def _wbits_cols_of_bl(bl: np.ndarray) -> np.ndarray:
    """Per-column :func:`_wbits` from precomputed (n_in, n_out) bit lengths."""
    mx = bl.max(axis=0)
    return np.where(mx > 0, mx, 1) + 1


def _sls_cols(w: np.ndarray) -> np.ndarray:
    """Per-column smallest left shift (:func:`~repro_torch.core.tuning.sls_of`)."""
    lls = csd.largest_left_shift_array(w)       # 63 sentinel for zeros
    has = (w != 0).any(axis=0)
    return np.where(has, lls.min(axis=0), 0)


def cycle_count(mlp: IntMLP, arch: str) -> int:
    iotas = [w.shape[0] for w in mlp.weights]       # inputs per layer
    etas = [w.shape[1] for w in mlp.weights]        # neurons per layer
    if arch == "parallel":
        return 1
    if arch == "smac_neuron":
        return sum(i + 1 for i in iotas)
    if arch == "smac_ann":
        return sum((i + 2) * e for i, e in zip(iotas, etas))
    raise ValueError(arch)


# ---------------------------------------------------------------------------
# Shared pricing blocks (deduplicated across the three builders)
# ---------------------------------------------------------------------------

def _bound_adder_addends(g, tech, input_max: int):
    """(area, energy, n_adders) of one plan's value-bound adders — memoized
    on the (planner-shared) graph instance, so repeat pricing is one dict
    hit."""
    key = ("priced-adders", input_max, tech)
    cached = g._memo.get(key)
    if cached is None:
        bounds = np.asarray(g.value_bounds(input_max=input_max),
                            dtype=np.int64)
        a, _, e = adder_vec(csd.bit_length_array(bounds) + 1, tech)
        cached = g._memo[key] = (a, e, g.n_adders)
    return cached


def _price_graph_bounds(sheet: CostSheet, graphs, tech, kind: str = "adder",
                        input_max: int = 1 << (BITS_X - 1)) -> None:
    """One adder per plan node/output, sized by its value bound — the block
    every multiplierless style prices.  Vectorized over the concatenated
    bound addends of a whole run of plans (graph order preserved, so the
    ledger order equals the scalar builders' graph-by-graph loop)."""
    priced = [_bound_adder_addends(g, tech, input_max) for g in graphs]
    n_adders = sum(p[2] for p in priced)
    if len(priced) == 1:
        a, e, _ = priced[0]
    else:
        a = np.concatenate([p[0] for p in priced])
        e = np.concatenate([p[1] for p in priced])
    sheet.add(kind, area=a, energy=e, count=n_adders)


def _price_activation_units(sheet: CostSheet, abits: int, n_out: int,
                            tech) -> Primitive:
    """The per-layer activation-unit bank (one clamp/shift unit per neuron)."""
    au = hwmodel.activation_unit(abits, tech)
    sheet.add_primitive("act", au, n=n_out, count=n_out)
    return au


def _price_bias_adders(sheet: CostSheet, abits: int, n_out: int,
                       tech) -> Primitive:
    """The per-layer bias-adder bank (one accumulator-width adder per neuron)."""
    bias_add = adder(abits, tech)
    sheet.add_primitive("adder", bias_add, n=n_out, count=n_out)
    return bias_add


# ---------------------------------------------------------------------------
# Parallel architecture (cost-IR builder)
# ---------------------------------------------------------------------------

def _parallel(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    sheet = CostSheet(tech)     # one flat ledger: the scalar builder keeps a
    path = 0.0                  # single running accumulator across layers
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        n_in, n_out = w.shape
        bl = csd.bit_length_array(w)                      # one recoding/layer
        abits = acc_bits(n_in + 1, BITS_X, _wbits_of_bl(bl))
        if style == "behavioral":
            nzmask = w != 0
            nz = nzmask.sum(axis=0)                       # per neuron column
            wb = bl + 1                                   # per-element _wbits
            m_area, m_delay, m_energy = multiplier_vec(BITS_X, wb, tech)
            maskT = nzmask.T.ravel()                      # neuron-major order
            tree = adder(abits, tech)
            n_tree = np.maximum(0, nz - 1) + 1            # + bias adder
            # ledger order = the scalar loop's: column m's multipliers, then
            # its adder-tree addend, then column m+1 ...
            ins = np.cumsum(nz)
            sheet.add("mult+tree",
                      area=np.insert(m_area.T.ravel()[maskT], ins,
                                     tree.area * n_tree),
                      energy=np.insert(m_energy.T.ravel()[maskT], ins,
                                       tree.energy * n_tree))
            sheet.add("mult", count=int(nz.sum()))
            sheet.add("adder", count=int(n_tree.sum()))
            mult_delay = float(m_delay.T.ravel()[maskT].max()) \
                if maskT.any() else 0.0
            depth = np.ceil(np.log2(np.maximum(2, nz))).astype(np.int64) + 1
            tree_delay = float((depth * tree.delay).max()) if n_out else 0.0
            # layer critical path = slowest multiplier + slowest adder tree
            # (neurons are parallel, not chained)
            layer_delay = mult_delay + tree_delay
        elif style in ("cavm", "cmvm"):
            # shared planner: simurg.generate and repeat pricing reuse these
            if style == "cavm":
                graphs = planner.cavm_graphs(w)
            else:
                graphs = [planner.cmvm_graph(w)]   # (n_out, n_in) matrix
            ad = adder(abits, tech)
            _price_graph_bounds(sheet, graphs, tech)
            gdelay = max((g.depth * ad.delay for g in graphs), default=0.0)
            bias_add = _price_bias_adders(sheet, abits, n_out, tech)
            layer_delay = gdelay + bias_add.delay
        else:
            raise ValueError(style)
        au = _price_activation_units(sheet, abits, n_out, tech)
        layer_delay += au.delay
        path += layer_delay
    # output flip-flops (paper: added for fair comparison with time-mux)
    n_final = mlp.weights[-1].shape[1]
    reg = register(BITS_X, tech)
    sheet.add_primitive("register", reg, n=n_final, count=n_final)
    area = sheet.fold_area()
    clock = path + reg.delay
    leak = area * tech.leak_uw_per_um2 * clock * 1e-3  # fJ
    tally = sheet.tally()
    return DesignReport("parallel", style, area, clock,
                        sheet.fold_energy() + leak, 1, clock,
                        tally.get("adder", 0), tally.get("mult", 0),
                        detail={"components": tally, "engine": "array"})


# ---------------------------------------------------------------------------
# SMAC architectures (cost-IR builders)
# ---------------------------------------------------------------------------

def _smac_neuron(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    sheet = CostSheet(tech)     # per-layer sub-sheets: the scalar builder
    e_cycle_layers = []         # accumulates layer_area then area += it
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        n_in, n_out = w.shape
        lsheet = CostSheet(tech)
        bl = csd.bit_length_array(w)                      # one recoding/layer
        wb_cols = _wbits_cols_of_bl(bl)
        wbits_w = _wbits_of_bl(bl)
        if style == "behavioral":
            wb = np.maximum(1, wb_cols - _sls_cols(w))   # IV-C: narrowed path
            abits = BITS_X + wb + int(np.ceil(np.log2(max(2, n_in + 1))))
            m_a, m_d, m_e = multiplier_vec(BITS_X, wb, tech)
            a_a, a_d, a_e = adder_vec(abits, tech)
            r_a, r_d, r_e = register_vec(abits, tech)
            x_a, x_d, x_e = mux_vec(n_in, wb, tech)
            # one MAC addend per neuron: mult + acc + reg + weight mux, the
            # scalar builder's left-associated sum
            lsheet.add("mac", area=((m_a + a_a) + r_a) + x_a,
                       energy=((m_e + a_e) + r_e) + x_e,
                       delay=((m_d + a_d) + r_d) + x_d)
            lsheet.add("mult", count=n_out)
            lsheet.add("adder", count=n_out)
        elif style == "mcm":
            # Fig. 9: one MCM block for all layer weights x the muxed input
            consts = np.unique(np.abs(w[w != 0]).astype(np.int64))
            if consts.size == 0:
                consts = np.asarray([1], dtype=np.int64)
            g = planner.mcm_graph(consts)               # MCM: (m,1) matrix
            _price_graph_bounds(lsheet, [g], tech)
            mcm_delay = g.depth * adder(BITS_X + wbits_w, tech).delay
            abits = (BITS_X + wb_cols
                     + int(np.ceil(np.log2(max(2, n_in + 1)))))
            a_a, a_d, a_e = adder_vec(abits, tech)
            r_a, r_d, r_e = register_vec(abits, tech)
            p_a, p_d, p_e = mux_vec(len(consts), abits, tech)  # product sel
            lsheet.add("mac", area=(a_a + r_a) + p_a,
                       energy=(a_e + r_e) + p_e,
                       delay=((mcm_delay + p_d) + a_d) + r_d)
            lsheet.add("adder", count=n_out)
        else:
            raise ValueError(style)
        # shared per-layer input mux + control counter + activation bank
        imux = mux(n_in, BITS_X, tech)
        ctrl = hwmodel.counter(max(1, int(np.ceil(np.log2(n_in + 1)))), tech)
        au = hwmodel.activation_unit(BITS_X + wbits_w, tech)
        lsheet.add("ctrl+act",
                   area=(imux.area + ctrl.area) + au.area * n_out,
                   energy=imux.energy + ctrl.energy)
        e_cycle_layers.append((lsheet.fold_energy(), n_in + 1))
        sheet.add_sheet(lsheet, kind="layer")
    cycles = cycle_count(mlp, "smac_neuron")
    area = sheet.fold_area()
    clock = sheet.max_delay()
    # layer k is active only during its own iota_k+1 cycles (paper: disabled
    # layers save power); builtin sum, as in the reference's both engines
    energy = sum(e * c for e, c in e_cycle_layers)
    latency = cycles * clock
    # leakage at tech's density, so custom-tech energy stays comparable
    # across architectures
    leak = area * tech.leak_uw_per_um2 * latency * 1e-3
    tally = sheet.tally()
    return DesignReport("smac_neuron", style, area, latency, energy + leak,
                        cycles, clock, tally.get("adder", 0),
                        tally.get("mult", 0),
                        detail={"components": tally, "engine": "array"})


def _smac_ann(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    all_w = np.concatenate([w.ravel() for w in mlp.weights])
    sls = sls_of(all_w) if style == "behavioral" else 0
    wb = max(1, _wbits_array(all_w) - sls)
    max_in = max(w.shape[0] for w in mlp.weights)
    max_out = max(w.shape[1] for w in mlp.weights)
    n_weights = int(sum(w.size for w in mlp.weights))
    n_biases = int(sum(b.size for b in mlp.biases))
    abits = acc_bits(max_in + 1, BITS_X, wb)

    # the single shared datapath: ledger order = the scalar builder's area
    # expression, so the flat sequential fold reproduces it exactly
    sheet = CostSheet(tech)
    if style == "behavioral":
        core = hwmodel.multiplier(BITS_X, wb, tech)
        sheet.add_primitive("mult", core, count=1)
        core_delay = core.delay
    elif style == "mcm":
        consts = np.unique(np.abs(all_w[all_w != 0]).astype(np.int64))
        if consts.size == 0:
            consts = np.asarray([1], dtype=np.int64)
        g = planner.mcm_graph(consts)
        _price_graph_bounds(sheet, [g], tech)
        pmux = mux(len(consts), abits, tech)
        sheet.add_primitive("mux", pmux, count=1)
        core_delay = max(g.depth * adder(abits, tech).delay + pmux.delay,
                         pmux.delay)
    else:
        raise ValueError(style)

    acc = adder(abits, tech)
    sheet.add_primitive("adder", acc, count=1)
    reg = register(abits, tech)
    sheet.add_primitive("register", reg, count=1)
    imux = mux(max_in + max_out, BITS_X, tech)   # primary inputs + layer regs
    wmux = mux(n_weights, wb, tech)
    bmux = mux(n_biases, wb, tech)
    for m in (imux, wmux, bmux):
        sheet.add_primitive("mux", m, count=1)
    lregs = register(BITS_X, tech)
    sheet.add("register", area=lregs.area * max_out, count=max_out)
    ctrl = (hwmodel.counter(max(1, int(np.ceil(np.log2(len(mlp.weights) + 1)))), tech)
            + hwmodel.counter(max(1, int(np.ceil(np.log2(max_in + 2)))), tech)
            + hwmodel.counter(max(1, int(np.ceil(np.log2(max_out + 1)))), tech))
    sheet.add("counter", area=ctrl.area, energy=ctrl.energy, count=3)
    au = hwmodel.activation_unit(abits, tech)
    sheet.add("act", area=au.area, count=1)

    area = sheet.fold_area()
    e_cycle = sheet.fold_energy()
    clock = core_delay + acc.delay + reg.delay + max(imux.delay, wmux.delay)
    cycles = cycle_count(mlp, "smac_ann")
    latency = cycles * clock
    energy = e_cycle * cycles
    leak = area * tech.leak_uw_per_um2 * latency * 1e-3
    tally = sheet.tally()
    return DesignReport("smac_ann", style, area, latency, energy + leak,
                        cycles, clock, tally.get("adder", 0),
                        tally.get("mult", 0),
                        detail={"components": tally, "engine": "array"})


# ---------------------------------------------------------------------------
# Scalar builders (the per-scalar loops, the parity baseline of the array
# builders)
# ---------------------------------------------------------------------------

def _parallel_scalar(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    area = 0.0
    energy = 0.0
    path = 0.0
    n_adders = n_mults = 0
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        n_in, n_out = w.shape
        abits = acc_bits(n_in + 1, BITS_X, _wbits(w))
        layer_delay = 0.0
        if style == "behavioral":
            mult_delay = 0.0
            tree_delay = 0.0
            for m in range(n_out):
                col = w[:, m]
                nz = int(np.count_nonzero(col))
                for v in col:
                    if int(v) != 0:
                        p = hwmodel.multiplier(BITS_X, _wbits([v]), tech)
                        area += p.area
                        energy += p.energy
                        mult_delay = max(mult_delay, p.delay)
                        n_mults += 1
                tree = adder(abits, tech)
                n_tree = max(0, nz - 1) + 1          # + bias adder
                area += tree.area * n_tree
                energy += tree.energy * n_tree
                depth = int(np.ceil(np.log2(max(2, nz)))) + 1
                tree_delay = max(tree_delay, depth * tree.delay)
                n_adders += n_tree
            layer_delay = mult_delay + tree_delay
        elif style in ("cavm", "cmvm"):
            if style == "cavm":
                graphs = planner.cavm_graphs(w)
            else:
                graphs = [planner.cmvm_graph(w)]   # (n_out, n_in) matrix
            gdelay = 0.0
            for g in graphs:
                for bnd in g.value_bounds(input_max=(1 << (BITS_X - 1))):
                    p = adder(max(1, int(bnd).bit_length() + 1), tech)
                    area += p.area
                    energy += p.energy
                n_adders += g.n_adders
                gdelay = max(gdelay, g.depth * adder(abits, tech).delay)
            bias_add = adder(abits, tech)
            area += bias_add.area * n_out
            energy += bias_add.energy * n_out
            layer_delay = gdelay + bias_add.delay
            n_adders += n_out
        else:
            raise ValueError(style)
        au = hwmodel.activation_unit(abits, tech)
        area += au.area * n_out
        energy += au.energy * n_out
        layer_delay += au.delay
        path += layer_delay
    n_final = mlp.weights[-1].shape[1]
    reg = register(BITS_X, tech)
    area += reg.area * n_final
    energy += reg.energy * n_final
    clock = path + reg.delay
    leak = area * tech.leak_uw_per_um2 * clock * 1e-3  # fJ
    return DesignReport("parallel", style, area, clock, energy + leak, 1,
                        clock, n_adders, n_mults)


def _smac_neuron_scalar(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    area = 0.0
    e_cycle_layers = []
    clock = 0.0
    n_adders = n_mults = 0
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        n_in, n_out = w.shape
        layer_area = 0.0
        layer_ecycle = 0.0
        if style == "behavioral":
            for m in range(n_out):
                col = w[:, m]
                sls = sls_of(col)
                wb = max(1, _wbits(col) - sls)       # IV-C: datapath narrowed
                abits = acc_bits(n_in + 1, BITS_X, wb)
                mult = hwmodel.multiplier(BITS_X, wb, tech)
                acc = adder(abits, tech)
                reg = register(abits, tech)
                wmux = mux(n_in, wb, tech)
                layer_area += mult.area + acc.area + reg.area + wmux.area
                layer_ecycle += mult.energy + acc.energy + reg.energy + wmux.energy
                clock = max(clock, mult.delay + acc.delay + reg.delay
                            + wmux.delay)
                n_mults += 1
                n_adders += 1
        elif style == "mcm":
            consts = np.asarray(sorted({abs(int(v)) for v in w.ravel()
                                        if int(v) != 0}), dtype=np.int64)
            if consts.size == 0:
                consts = np.asarray([1], dtype=np.int64)
            g = planner.mcm_graph(consts)               # MCM: (m,1) matrix
            for bnd in g.value_bounds(input_max=(1 << (BITS_X - 1))):
                p = adder(max(1, int(bnd).bit_length() + 1), tech)
                layer_area += p.area
                layer_ecycle += p.energy
            n_adders += g.n_adders
            mcm_delay = g.depth * adder(BITS_X + _wbits(w), tech).delay
            for m in range(n_out):
                abits = acc_bits(n_in + 1, BITS_X, _wbits(w[:, m]))
                acc = adder(abits, tech)
                reg = register(abits, tech)
                pmux = mux(len(consts), abits, tech)  # product select (Fig. 9)
                layer_area += acc.area + reg.area + pmux.area
                layer_ecycle += acc.energy + reg.energy + pmux.energy
                clock = max(clock, mcm_delay + pmux.delay + acc.delay
                            + reg.delay)
                n_adders += 1
        else:
            raise ValueError(style)
        imux = mux(n_in, BITS_X, tech)
        ctrl = hwmodel.counter(max(1, int(np.ceil(np.log2(n_in + 1)))), tech)
        au = hwmodel.activation_unit(BITS_X + _wbits(w), tech)
        layer_area += imux.area + ctrl.area + au.area * n_out
        layer_ecycle += imux.energy + ctrl.energy
        area += layer_area
        e_cycle_layers.append((layer_ecycle, w.shape[0] + 1))
    cycles = cycle_count(mlp, "smac_neuron")
    energy = sum(e * c for e, c in e_cycle_layers)
    latency = cycles * clock
    leak = area * tech.leak_uw_per_um2 * latency * 1e-3
    return DesignReport("smac_neuron", style, area, latency, energy + leak,
                        cycles, clock, n_adders, n_mults)


def _smac_ann_scalar(mlp: IntMLP, style: str, tech, planner) -> DesignReport:
    all_w = np.concatenate([w.ravel() for w in mlp.weights])
    sls = sls_of(all_w) if style == "behavioral" else 0
    wb = max(1, _wbits(all_w) - sls)
    max_in = max(w.shape[0] for w in mlp.weights)
    max_out = max(w.shape[1] for w in mlp.weights)
    n_weights = int(sum(w.size for w in mlp.weights))
    n_biases = int(sum(b.size for b in mlp.biases))
    abits = acc_bits(max_in + 1, BITS_X, wb)

    n_adders = n_mults = 0
    if style == "behavioral":
        core = hwmodel.multiplier(BITS_X, wb, tech)
        n_mults = 1
    elif style == "mcm":
        consts = np.asarray(sorted({abs(int(v)) for v in all_w if int(v) != 0}),
                            dtype=np.int64)[:, None]
        g = planner.mcm_graph(consts)
        a = e = 0                         # left to right, like the array
        for b in g.value_bounds(1 << (BITS_X - 1)):     # engine's fold
            p = adder(max(1, int(b).bit_length() + 1), tech)
            a += p.area
            e += p.energy
        core = Primitive(a, g.depth * adder(abits, tech).delay
                         + mux(len(consts), abits, tech).delay, e)
        core = core + mux(len(consts), abits, tech)
        n_adders += g.n_adders
    else:
        raise ValueError(style)

    acc = adder(abits, tech)
    n_adders += 1
    reg = register(abits, tech)
    imux = mux(max_in + max_out, BITS_X, tech)   # primary inputs + layer regs
    wmux = mux(n_weights, wb, tech)
    bmux = mux(n_biases, wb, tech)
    lregs = register(BITS_X, tech)
    ctrl = (hwmodel.counter(max(1, int(np.ceil(np.log2(len(mlp.weights) + 1)))), tech)
            + hwmodel.counter(max(1, int(np.ceil(np.log2(max_in + 2)))), tech)
            + hwmodel.counter(max(1, int(np.ceil(np.log2(max_out + 1)))), tech))
    au = hwmodel.activation_unit(abits, tech)

    area = (core.area + acc.area + reg.area + imux.area + wmux.area
            + bmux.area + lregs.area * max_out + ctrl.area + au.area)
    e_cycle = (core.energy + acc.energy + reg.energy + imux.energy
               + wmux.energy + bmux.energy + ctrl.energy)
    clock = core.delay + acc.delay + reg.delay + max(imux.delay, wmux.delay)
    cycles = cycle_count(mlp, "smac_ann")
    latency = cycles * clock
    energy = e_cycle * cycles
    leak = area * tech.leak_uw_per_um2 * latency * 1e-3
    return DesignReport("smac_ann", style, area, latency, energy + leak,
                        cycles, clock, n_adders, n_mults)


_BUILDERS = {
    "array": {"parallel": _parallel, "smac_neuron": _smac_neuron,
              "smac_ann": _smac_ann},
    "scalar": {"parallel": _parallel_scalar,
               "smac_neuron": _smac_neuron_scalar,
               "smac_ann": _smac_ann_scalar},
}


def design_cost(mlp: IntMLP, arch: str, style: str = "behavioral",
                tech=TECH40, engine: str = "array",
                planner=None) -> DesignReport:
    """Price an IntMLP under a Section III architecture + Section V style.

    ``engine="array"`` (default) prices through the vectorized cost IR;
    ``engine="scalar"`` is the per-scalar reference.  Both return
    bit-identical :class:`DesignReport` numbers (the array reports
    additionally carry a component tally in ``detail``).  ``planner``
    selects the shift-add plan cache the multiplierless styles synthesize
    through (default: the process-wide shared planner).
    """
    builders = _BUILDERS.get(engine)
    if builders is None:
        raise ValueError(engine)
    builder = builders.get(arch)
    if builder is None:
        raise ValueError(arch)
    # explicit None test: an empty SynthesisPlanner is falsy (len() == 0)
    return builder(mlp, style, tech,
                   default_planner if planner is None else planner)
