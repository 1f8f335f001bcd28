"""The paper's hardware-design path in repro_torch against the JAX package
on the CPU, with no tolerance: the rest of the CSD arithmetic and of the
planner, the gate-level cost model (primitives and ``CostSheet`` folds),
``design_cost`` for every (architecture, style) on both engines (held to
``tests/test_costir.py``'s hex-exact ``GOLDEN`` and to the reference's
array engine), and the files SIMURG writes, byte for byte."""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core import archs as jarchs
    from repro.core import csd as jcsd
    from repro.core import hwmodel as jhw
    from repro.core import planner as jplanner
    from repro.core import simurg as jsimurg
    from repro.core.intmlp import IntMLP as JIntMLP
except ImportError:
    jarchs = None
from repro_torch.core import archs, csd, hwmodel, planner, simurg
from repro_torch.core.intmlp import IntMLP

TESTS = Path(__file__).resolve().parent
FIELDS = ("area_um2", "latency_ns", "energy_pj", "cycles", "clock_ns",
          "n_adders", "n_mults")


def _costir():
    """``tests/test_costir.py``, imported by path: its ``GOLDEN`` table and
    its ``_mlp`` recipe."""
    spec = importlib.util.spec_from_file_location(
        "_costir_golden", TESTS / "test_costir.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(m):
    """The same integer network as the port's and the reference's IntMLP."""
    return (IntMLP([w.copy() for w in m.weights], [b.copy() for b in m.biases],
                   list(m.activations), m.q),
            JIntMLP([w.copy() for w in m.weights],
                    [b.copy() for b in m.biases], list(m.activations), m.q))


def _report(rep):
    return tuple(getattr(rep, f) for f in FIELDS)


# ---------------------------------------------------------------- csd, planner

def test_csd_scalar_helpers_equal():
    rng = np.random.default_rng(3)
    v = rng.integers(-70000, 70000, size=(9, 11))
    v[0, :4] = [0, 1, -1, 1 << 20]
    for x in v.ravel().tolist() + [2 ** 40 - 1, -(2 ** 33)]:
        assert csd.nnz(x) == jcsd.nnz(x)
        assert csd.largest_left_shift(x) == jcsd.largest_left_shift(x)
    np.testing.assert_array_equal(csd.bit_length_array(v),
                                  jcsd.bit_length_array(v))
    big = np.array([(1 << 60) - 1, -(1 << 60), 0, 255, -256], np.int64)
    np.testing.assert_array_equal(csd.bit_length_array(big),
                                  jcsd.bit_length_array(big))
    with pytest.raises(OverflowError):
        csd.bit_length_array(np.array([1 << 62], np.int64))
    for engine in ("array", "scalar"):
        assert csd.tnzd([v, v[0]], engine=engine) == \
            jcsd.tnzd([v, v[0]], engine=engine)
    with pytest.raises(ValueError):
        csd.tnzd([v], engine="nope")


def _graph(g):
    return (g.n_inputs, g.nodes, g.outputs, g.n_adders, g.depth,
            g.value_bounds(input_max=128))


def test_planner_shapes_equal():
    rng = np.random.default_rng(4)
    ws = [rng.integers(-90, 91, (12, 7)), rng.integers(-90, 91, (7, 5))]
    p, jp = planner.SynthesisPlanner(), jplanner.SynthesisPlanner()
    for w in ws + ws:                       # the repeat hits the list memo
        assert [_graph(g) for g in p.cavm_graphs(w)] == \
            [_graph(g) for g in jp.cavm_graphs(w)]
        consts = np.unique(np.abs(w[w != 0]))
        assert _graph(p.mcm_graph(consts)) == _graph(jp.mcm_graph(consts))
        assert _graph(p.column_graph(w[:, 1])) == \
            _graph(jp.column_graph(w[:, 1]))
        assert p.column_adders(w[:, 2]) == jp.column_adders(w[:, 2])
    assert _graph(p.mcm_graph([])) == _graph(jp.mcm_graph([]))
    assert p.cavm_adder_cost(ws) == jp.cavm_adder_cost(ws) == \
        csd.tnzd(ws) - sum(w.shape[1] for w in ws)
    assert p.stats == jp.stats and len(p) == len(jp)
    # the module-level wrappers serve the process-wide planner
    assert planner.cavm_adder_cost(ws) == jplanner.cavm_adder_cost(ws)
    assert planner.cmvm_adder_cost(ws) == jplanner.cmvm_adder_cost(ws)
    assert _graph(planner.cmvm_graph(ws[0])) == \
        _graph(jplanner.cmvm_graph(ws[0]))
    assert _graph(planner.plan(ws[1])) == _graph(jplanner.plan(ws[1]))
    assert [_graph(g) for g in planner.cavm_graphs(ws[1])] == \
        [_graph(g) for g in jplanner.cavm_graphs(ws[1])]
    assert _graph(planner.mcm_graph([3, 5, 7])) == \
        _graph(jplanner.mcm_graph([3, 5, 7]))


# ------------------------------------------------------------- the cost model

def test_primitives_equal():
    tech = hwmodel.Tech(a_fa=3.7, d_mux=0.041)
    assert hwmodel.TECH40 == hwmodel.Tech() and \
        jhw.TECH40.__dict__ == hwmodel.TECH40.__dict__
    bits = np.arange(0, 45)
    for t, jt in ((hwmodel.TECH40, jhw.TECH40),
                  (tech, jhw.Tech(a_fa=3.7, d_mux=0.041))):
        for b in bits.tolist():
            for f, jf in ((hwmodel.adder, jhw.adder),
                          (hwmodel.register, jhw.register),
                          (hwmodel.counter, jhw.counter),
                          (hwmodel.activation_unit, jhw.activation_unit)):
                assert f(b, t).__dict__ == jf(b, jt).__dict__
            assert hwmodel.multiplier(8, b, t).__dict__ == \
                jhw.multiplier(8, b, jt).__dict__
            assert hwmodel.mux(b + 1, 13, t).__dict__ == \
                jhw.mux(b + 1, 13, jt).__dict__
            assert hwmodel.acc_bits(b, 8, 7) == jhw.acc_bits(b, 8, 7)
        s = hwmodel.adder(9, t) + hwmodel.mux(5, 3, t)
        assert s.__dict__ == (jhw.adder(9, jt) + jhw.mux(5, 3, jt)).__dict__
        for got, want in ((hwmodel.adder_vec(bits, t),
                           jhw.adder_vec(bits, jt)),
                          (hwmodel.multiplier_vec(8, bits, t),
                           jhw.multiplier_vec(8, bits, jt)),
                          (hwmodel.mux_vec(16, bits, t),
                           jhw.mux_vec(16, bits, jt)),
                          (hwmodel.register_vec(bits, t),
                           jhw.register_vec(bits, jt))):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def _fill(sheet_cls, prim, layers):
    parent = sheet_cls()
    for i, lay in enumerate(layers):
        child = sheet_cls()
        child.add("adder", area=lay, energy=lay[::-1] * 0.37,
                  delay=lay[:3], count=len(lay))
        child.add_primitive("mult", prim(3 + i, 7), n=i + 2)
        child.add("mux", area=float(lay[0]), count=1)  # scalar addend path
        parent.add_sheet(child, kind="layer")
    parent.add("register", area=layers[0][:5], count=5)
    parent.add("tally-only", count=4)
    return parent


def test_costsheet_folds_equal():
    rng = np.random.default_rng(1)
    layers = [rng.uniform(0.1, 9.9, 37 + 5 * i) for i in range(3)]
    got = _fill(hwmodel.CostSheet, hwmodel.multiplier, layers)
    want = _fill(jhw.CostSheet, jhw.multiplier, layers)
    assert got.fold_area() == want.fold_area()
    assert got.fold_energy() == want.fold_energy()
    assert got.max_delay() == want.max_delay()
    assert got.tally() == want.tally()
    assert len(got) == len(want)
    # the fold is the left-to-right chain of a scalar accumulation loop
    flat = np.concatenate(layers[:1] + [rng.uniform(0, 3, 999)])
    sheet = hwmodel.CostSheet()
    sheet.add("x", area=flat)
    total = 0.0
    for a in flat:
        total += float(a)
    assert sheet.fold_area() == total
    assert hwmodel.CostSheet().fold_area() == 0.0


# ---------------------------------------------------------------- design_cost

def _golden_cases():
    if jarchs is None:
        return []
    g = _costir().GOLDEN
    return [(fx, eng) for fx in sorted(g, key=str)
            for eng in ("array", "scalar")]


@pytest.mark.parametrize("fixture,engine", _golden_cases(), ids=str)
def test_design_cost_equals_golden(fixture, engine):
    """Both of the port's engines hit the hex-exact pins of every
    (arch, style), including the scalar rows the reference's own scalar
    engine misses under Python 3.12's compensated builtin ``sum``."""
    tc = _costir()
    sid, seed, wmax = fixture
    m, _ = _both(tc._mlp(tuple(int(x) for x in sid.split("-")), seed=seed,
                         wmax=wmax))
    for (arch, style), want in tc.GOLDEN[fixture].items():
        rep = archs.design_cost(m, arch, style, engine=engine)
        assert _report(rep) == tuple(tc._unhex(v) for v in want), \
            (arch, style)


RANDOM_NETS = [((16, 16, 10, 10), 7, 31), ((16, 10, 10), 11, 200),
               ((5, 3), 4, 4), ((12, 7, 9), 13, 1000),
               ((16, 16, 10), 21, 63), ((16, 10), 22, 127)]


@pytest.mark.parametrize("net", RANDOM_NETS, ids=str)
def test_design_cost_equals_reference_array_engine(net):
    """Every DesignReport field of both port engines equals the reference's
    array engine with ``==`` (the array engine's component tally too), on
    ``test_costir._mlp``'s seeded networks, with a fresh planner per side
    whose hit/miss ledger must match as well."""
    structure, seed, wmax = net
    m, jm = _both(_costir()._mlp(structure, seed=seed, wmax=wmax))
    p, jp = planner.SynthesisPlanner(), jplanner.SynthesisPlanner()
    for arch, style in archs.ARCH_STYLES:
        want = jarchs.design_cost(jm, arch, style, planner=jp)
        got = archs.design_cost(m, arch, style, planner=p)
        assert (_report(got), got.detail, got.arch, got.style) == \
            (_report(want), want.detail, want.arch, want.style)
        got_s = archs.design_cost(m, arch, style, engine="scalar")
        assert _report(got_s) == _report(want) and got_s.detail == {}
        assert archs.cycle_count(m, arch) == jarchs.cycle_count(jm, arch)
    assert p.stats == jp.stats


def test_design_cost_edges_equal():
    z = IntMLP([np.zeros((4, 3), np.int64)], [np.zeros(3, np.int64)],
               ["hsig"], q=3)
    jz = JIntMLP([np.zeros((4, 3), np.int64)], [np.zeros(3, np.int64)],
                 ["hsig"], q=3)
    tech = hwmodel.Tech(leak_uw_per_um2=0.01)
    jtech = jhw.Tech(leak_uw_per_um2=0.01)
    m, jm = _both(_costir()._mlp((8, 6, 4), seed=5))
    for arch, style in archs.ARCH_STYLES:
        for net, jnet in ((z, jz), (m, jm)):
            want = _report(jarchs.design_cost(jnet, arch, style, tech=jtech))
            for engine in ("array", "scalar"):
                assert _report(archs.design_cost(
                    net, arch, style, tech=tech, engine=engine)) == want
    assert archs.ARCH_STYLES == jarchs.ARCH_STYLES
    assert archs.BITS_X == jarchs.BITS_X
    assert archs.design_cost(m, "smac_ann").row() == \
        jarchs.design_cost(jm, "smac_ann").row()
    for bad in ({"engine": "nope"}, {"arch": "mesh"}):
        kw = dict({"arch": "parallel"}, **bad)
        with pytest.raises(ValueError):
            archs.design_cost(m, kw.pop("arch"), **kw)
    with pytest.raises(ValueError):
        archs.design_cost(m, "parallel", "mcm")
    with pytest.raises(ValueError):
        archs.cycle_count(m, "mesh")


# -------------------------------------------------------------------- SIMURG

def _simurg_mlp(structure, seed=0):
    """``tests/test_archs_simurg.py``'s network recipe."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for a, b in zip(structure[:-1], structure[1:]):
        ws.append(rng.integers(-63, 64, (a, b)).astype(np.int64))
        bs.append(rng.integers(-15, 16, (b,)).astype(np.int64))
    acts = ["htanh"] * (len(structure) - 2) + ["hsig"]
    return IntMLP(ws, bs, acts, q=5)


def _files(d):
    return {f: (Path(d) / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("arch,style", archs.ARCH_STYLES,
                         ids=lambda v: str(v))
def test_simurg_files_equal(arch, style, tmp_path):
    """``generate(...).write()`` writes the reference's bytes: Verilog,
    testbench, vectors (numpy ``default_rng(0)`` stimuli through
    ``forward_int``), synthesis script and cost report, on
    ``test_archs_simurg.py``'s networks and on a 4-layer one."""
    for structure, top in (((16, 10), "ann_t"), ((16, 16, 10), "ann"),
                           ((16, 16, 10, 10), "pendigits_ann")):
        m, jm = _both(_simurg_mlp(structure))
        got, want = tmp_path / f"p{top}", tmp_path / f"r{top}"
        out = simurg.generate(m, arch=arch, style=style, top=top)
        out.write(str(got))
        jsimurg.generate(jm, arch=arch, style=style, top=top).write(str(want))
        assert set(_files(got)) == {f"{top}.v", f"tb_{top}.v",
                                    "vectors.txt", "synth.tcl",
                                    "report.json"}
        assert _files(got) == _files(want), (structure, arch, style)
        assert len(out.vectors.splitlines()) == 16
    x = np.random.default_rng(9).integers(-128, 128, (5, 16))
    a = simurg.generate(m, arch=arch, style=style, x_test_int=x)
    b = jsimurg.generate(jm, arch=arch, style=style, x_test_int=x)
    assert (a.verilog, a.testbench, a.vectors, a.synth_tcl) == \
        (b.verilog, b.testbench, b.vectors, b.synth_tcl)
