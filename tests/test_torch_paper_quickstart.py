"""The port's quickstart pipeline (train -> ``find_min_q`` ->
``tune_parallel(cost="adders")`` -> ``tune_time_multiplexed`` ->
``design_cost`` -> ``simurg.generate``, every backend on ``auto``) run on
the CPU at a small size, and held against the JAX package's search, tuners,
pricing and SIMURG from the same float weights: the same ``(q, ha,
history)``, the same ``TuneResult``s, the same test-split scores, the same
``DesignReport`` numbers and the same SIMURG bytes."""
import os

import numpy as np
import pytest

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core import find_min_q as jfind_min_q
    from repro.core import simurg as jsimurg
    from repro.core import tune_parallel as jtune_parallel
    from repro.core import tune_time_multiplexed as jtune_tm
    from repro.core.archs import design_cost as jdesign_cost
    from repro.core.intmlp import hardware_accuracy as jhardware_accuracy
except ImportError:
    jfind_min_q = None
from repro_torch.launch import quickstart

SWEEPS, ROWS, CHUNK = 1, 300, 16
FIELDS = ("arch", "style", "area_um2", "latency_ns", "energy_pj", "cycles",
          "clock_ns", "n_adders", "n_mults", "detail")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("quickstart") / "simurg"
    return quickstart.run_pipeline("cpu", epochs=2, max_sweeps=SWEEPS,
                                   val_rows=ROWS, chunk=CHUNK,
                                   out_dir=str(out))


@pytest.fixture(scope="module")
def reference(run):
    """The reference's min-q and IV-B tuner on the run's float weights."""
    r = run
    want_q = jfind_min_q(r.train.weights, r.train.biases, r.acts, r.x_val,
                         r.y_val)
    want = jtune_parallel(want_q.mlp, r.x_val, r.y_val, cost="adders",
                          max_sweeps=SWEEPS, chunk=CHUNK, backend="jnp")
    return want_q, want


def _assert_tune_equal(got, want):
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        np.testing.assert_array_equal(a, b)
    assert (got.bha, got.initial_ha, got.replacements, got.sweeps,
            got.log) == (want.bha, want.initial_ha, want.replacements,
                         want.sweeps, want.log)
    assert dict(got.stats, backend="jnp") == want.stats


def test_quickstart_pipeline_equals_reference(run, reference):
    r = run
    want_q, want = reference
    assert r.x_val.shape == (ROWS, quickstart.STRUCTURE[0])
    assert r.sweep_ev.backend == "numpy" and r.tp.stats["backend"] == "torch"
    assert set(r.seconds) == {"train", "min_q", "tune", "tm", "price",
                              "simurg"}

    assert (r.qr.q, r.qr.ha, r.qr.history) == \
        (want_q.q, want_q.ha, want_q.history)
    _assert_tune_equal(r.tp, want)
    assert r.tp.stats["tnzd_final"] < r.tp.stats["tnzd_initial"]

    assert r.test_ha == (
        jhardware_accuracy(want_q.mlp, r.x_test, r.y_test),
        jhardware_accuracy(want.mlp, r.x_test, r.y_test))


def test_quickstart_design_steps_equal_reference(run, reference, tmp_path):
    """Steps 3b-5 from the same weights: the IV-C tuner's ``TuneResult``,
    the priced design rows and the SIMURG files equal the reference's."""
    r = run
    want_q, want = reference
    want_tm = jtune_tm(want_q.mlp, r.x_val, r.y_val, scope="neuron",
                       max_sweeps=quickstart.TM_SWEEPS, backend="jnp",
                       chain_engine="host")
    assert r.tm.stats["backend"] == "torch"
    _assert_tune_equal(r.tm, want_tm)
    assert r.tm.replacements > 0

    nets = {"tp": want.mlp, "tm": want_tm.mlp}
    rows = [jdesign_cost(nets[net], arch, style)
            for arch, net, styles in quickstart.DESIGN_ROWS
            for style in styles]
    assert len(r.designs) == len(rows) == 6
    for got, ref in zip(r.designs, rows):
        assert tuple(getattr(got, f) for f in FIELDS) == \
            tuple(getattr(ref, f) for f in FIELDS)
        assert got.row() == ref.row()
    for got, scalar in zip(r.designs,
                           quickstart.price_designs(r.tp, r.tm, "scalar")):
        assert tuple(getattr(got, f) for f in FIELDS[:-1]) == \
            tuple(getattr(scalar, f) for f in FIELDS[:-1])

    jsimurg.generate(want.mlp, arch="parallel", style="cmvm",
                     top="pendigits_ann").write(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert sorted(os.listdir(r.out_dir)) == names == sorted(
        ["pendigits_ann.v", "tb_pendigits_ann.v", "vectors.txt", "synth.tcl",
         "report.json"])
    for name in names:
        with open(os.path.join(r.out_dir, name), "rb") as f, \
                open(tmp_path / name, "rb") as g:
            assert f.read() == g.read(), name
