"""The time-multiplexed tuner (paper IV-C) of repro_torch against the JAX
package on the CPU, with no tolerance: ``tune_time_multiplexed`` for scopes
``neuron`` and ``ann``, engines ``batched`` and ``serial``, backends
``numpy`` and ``torch``, on the inputs of
``test_intmlp_quant_tuning.py::test_tune_time_multiplexed_raises_sls`` and
``::test_tune_ann_scope`` (16-10 trained on the pendigits surrogate,
min-q with ``hsig``); ``evaluate_tm_chain``'s decisions against the
reference's host chain, its errors, and the device chain's decisions
against the host's.  On the card (``gpu`` marker) the tuner on ``csd`` equals
``numpy``."""
import warnings

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core import find_min_q as jfind_min_q
    from repro.core import quantize_inputs as jquantize_inputs
    from repro.core.intmlp import IntMLP as JIntMLP
    from repro.core.tuning import _sls_candidates as j_sls_candidates
    from repro.core.tuning import tune_time_multiplexed as jtune_tm
    from repro.data import pendigits as jpd
    from repro.eval import BatchedHWEvaluator as JEvaluator
    from repro.eval import TMStep as JTMStep
    from repro.train.zaal import TrainConfig as JTrainConfig
    from repro.train.zaal import train as jtrain
except ImportError:
    jtune_tm = None
from repro_torch.core import find_min_q, tune_time_multiplexed
from repro_torch.core.intmlp import IntMLP
from repro_torch.core.tuning import _neuron_groups, _sls_candidates, sls_of
from repro_torch.eval import BatchedHWEvaluator, TMStep

JNP = {"torch": "jnp", "numpy": "numpy"}   # the reference's backend names


@pytest.fixture(scope="module")
def trained():
    """The reference tests' inputs: 16-10 ZAAL-trained (25 epochs, seed 3)
    on the pendigits surrogate, at the ``hsig`` min-q."""
    ds = jpd.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = jtrain(JTrainConfig(structure=(16, 10), epochs=25, seed=3),
                 jpd.to_unit(xtr), ytr, jpd.to_unit(xval), yval)
    x = jquantize_inputs(jpd.to_unit(xval))
    qr = jfind_min_q(res.weights, res.biases, ("hsig",), x, yval)
    mine = find_min_q(res.weights, res.biases, ("hsig",), x, yval,
                      device="cpu")
    assert (mine.q, mine.ha, mine.history) == (qr.q, qr.ha, qr.history)
    return qr.mlp, x, yval


def _port(m):
    return IntMLP([w.copy() for w in m.weights], [b.copy() for b in m.biases],
                  list(m.activations), m.q)


def _jref(m):
    return JIntMLP([w.copy() for w in m.weights],
                   [b.copy() for b in m.biases], list(m.activations), m.q)


def _assert_same(got, want, backend_name, candidates=True):
    """Equal results and stats; ``candidates=False`` leaves out
    ``stats["candidates"]``, which the device chain engine counts otherwise
    than the host's."""
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        np.testing.assert_array_equal(a, b)
    assert (got.bha, got.initial_ha, got.replacements, got.sweeps,
            got.log) == (want.bha, want.initial_ha, want.replacements,
                         want.sweeps, want.log)
    stats, want_stats = dict(got.stats), dict(want.stats)
    if "backend" in stats:
        stats["backend"] = backend_name
    if not candidates:
        stats.pop("candidates")
        want_stats.pop("candidates")
    assert stats == want_stats


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("engine", ["batched", "serial"])
@pytest.mark.parametrize("scope", ["neuron", "ann"])
def test_tune_time_multiplexed_equals_reference(trained, scope, engine,
                                                backend):
    mlp, x, y = trained
    got = tune_time_multiplexed(_port(mlp), x, y, scope=scope, max_sweeps=2,
                                engine=engine, backend=backend, device="cpu")
    want = jtune_tm(_jref(mlp), x, y, scope=scope, max_sweeps=2,
                    engine=engine, backend=JNP[backend], chain_engine="host")
    _assert_same(got, want, JNP[backend])
    assert got.bha >= got.initial_ha and got.replacements > 0
    if engine == "batched":
        assert got.stats["backend"] == backend
    if scope == "neuron":           # the paper's IV-C objective
        groups = list(_neuron_groups(mlp, "neuron"))
        before = [sls_of(mlp.weights[k][:, m]) for [(k, m)] in groups]
        after = [sls_of(got.mlp.weights[k][:, m]) for [(k, m)] in groups]
        assert sum(after) >= sum(before)


def test_tune_tm_on_a_deeper_net_with_nudges():
    """A seeded 10-8-6 net (``test_costir.py``'s device-chain fixture) where
    bias nudges accept: three sweeps, both scopes, chunk and bias range
    changed, against the reference on the torch backend."""
    rng = np.random.default_rng(2)
    ws = [(rng.integers(-40, 41, (10, 8)) * rng.integers(1, 3, (10, 8)))
          .astype(np.int64), (rng.integers(-40, 41, (8, 6)) * 2)
          .astype(np.int64)]
    bs = [rng.integers(-8, 9, 8).astype(np.int64),
          rng.integers(-8, 9, 6).astype(np.int64)]
    m = IntMLP(ws, bs, ["htanh", "hsig"], q=5)
    xv = rng.integers(-128, 128, (250, 10)).astype(np.int64)
    yv = rng.integers(0, 6, 250)
    for scope in ("neuron", "ann"):
        got = tune_time_multiplexed(_port(m), xv, yv, scope=scope,
                                    max_sweeps=3, bias_range=3, chunk=16,
                                    backend="torch", device="cpu")
        want = jtune_tm(_jref(m), xv, yv, scope=scope, max_sweeps=3,
                        bias_range=3, chunk=16, backend="jnp",
                        chain_engine="host")
        _assert_same(got, want, "jnp")
        serial = tune_time_multiplexed(_port(m), xv, yv, scope=scope,
                                       max_sweeps=3, bias_range=3,
                                       engine="serial")
        assert serial.log == got.log


def _steps(mlp, scope, dbs=(-2, -1, 1, 2)):
    """Per-layer TMStep runs of every group's candidates, as the tuner
    builds them."""
    runs = {}
    for group in _neuron_groups(mlp, scope):
        for k, m, n, _w, pws in _sls_candidates(mlp, group):
            runs.setdefault(k, []).append(TMStep(k, m, n, tuple(pws), dbs))
    return runs


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_evaluate_tm_chain_equals_reference(trained, backend):
    """The host chain's decisions, accuracies and counters equal the
    reference's, and the committed state is untouched until commit_many."""
    mlp, x, y = trained
    ev = BatchedHWEvaluator(_port(mlp), x, y, backend=backend, device="cpu")
    jev = JEvaluator(_jref(mlp), x, y, backend=JNP[backend])
    for scope in ("ann", "neuron"):
        for k, steps in _steps(ev.mlp, scope).items():
            jsteps = [JTMStep(s.layer, s.col, s.row, s.pws, s.dbs)
                      for s in steps]
            bha = ev.accuracy()
            w0 = [w.copy() for w in ev.mlp.weights]
            got = ev.evaluate_tm_chain(steps, bha, engine="host")
            assert got == jev.evaluate_tm_chain(jsteps, bha, engine="host")
            assert got == ev.evaluate_tm_chain(steps, bha)     # auto: host
            for a, b in zip(ev.mlp.weights, w0):
                np.testing.assert_array_equal(a, b)
            assert ev.accuracy() == bha
            assert any(ok for ok, *_ in got)
            # the candidate lists match the reference tuner's own
            assert [(s.layer, s.col, s.row, s.pws) for s in steps] == [
                (kk, m, n, tuple(p)) for g in _neuron_groups(ev.mlp, scope)
                for kk, m, n, _w, p in j_sls_candidates(_jref(ev.mlp), g)
                if kk == k]
    # each run went through the port's chain twice (host, auto)
    assert (ev.stats["eval_calls"], ev.stats["candidates"]) == \
        (2 * jev.stats["eval_calls"], 2 * jev.stats["candidates"])


def test_evaluate_tm_chain_errors(trained):
    """The reference's ValueErrors; the device chain (ported since the
    device chains came) decides as the host chain, alone and in the
    tuner."""
    mlp, x, y = trained
    ev = BatchedHWEvaluator(_port(mlp), x, y, backend="torch", device="cpu")
    jev = JEvaluator(_jref(mlp), x, y, backend="numpy")
    bha = ev.accuracy()
    w = ev.mlp.weights[0]
    r, c = np.argwhere(w != 0)[0]
    v = int(w[r, c])
    good = TMStep(0, int(c), int(r), (v - 1,))
    bad = [([good, TMStep(1, 0, 0, (1,))], bha),          # two layers
           ([good, good], bha),                             # same weight
           ([TMStep(0, int(c), int(r), ())], bha),          # no candidate
           ([good], bha + 1.0)]                             # not the bha
    for steps, b in bad:
        with pytest.raises(ValueError):
            ev.evaluate_tm_chain(steps, b)
        with pytest.raises(ValueError):
            jev.evaluate_tm_chain([JTMStep(s.layer, s.col, s.row, s.pws,
                                           s.dbs) for s in steps], b,
                                  engine="host")
    with pytest.raises(ValueError):
        ev.evaluate_tm_chain([good], bha, engine="scan")
    assert ev.evaluate_tm_chain([], bha) == []
    assert ev.evaluate_tm_chain([good], bha, engine="device") == \
        ev.evaluate_tm_chain([good], bha, engine="host")
    dev = tune_time_multiplexed(_port(mlp), x, y, max_sweeps=1,
                                chain_engine="device", device="cpu")
    host = tune_time_multiplexed(_port(mlp), x, y, max_sweeps=1,
                                 chain_engine="host", device="cpu")
    assert (dev.bha, dev.replacements, dev.sweeps, dev.log) == \
        (host.bha, host.replacements, host.sweeps, host.log)
    assert all(np.array_equal(a, b) for a, b in
               zip(dev.mlp.weights + dev.mlp.biases,
                   host.mlp.weights + host.mlp.biases))
    with pytest.raises(ValueError):
        tune_time_multiplexed(_port(mlp), x, y, engine="loop", device="cpu")
    with pytest.raises(ValueError):
        tune_time_multiplexed(_port(mlp), x, y, scope="layer", device="cpu")


def test_tm_demotion_is_recorded_as_in_reference():
    """An int32-unsafe network demotes the torch backend to numpy with a
    warning, recorded in ``stats["demoted"]`` as the reference records
    it; the tuner's result is unchanged."""
    rng = np.random.default_rng(8)
    ws = [(rng.integers(-300, 301, (6, 5)) << 16).astype(np.int64),
          rng.integers(-20, 21, (5, 4)).astype(np.int64)]
    bs = [rng.integers(-9, 10, 5).astype(np.int64),
          rng.integers(-9, 10, 4).astype(np.int64)]
    m = IntMLP(ws, bs, ["htanh", "hsig"], q=22)
    xv = rng.integers(-128, 128, (120, 6)).astype(np.int64)
    yv = rng.integers(0, 4, 120)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tune_time_multiplexed(_port(m), xv, yv, max_sweeps=2,
                                    backend="torch", device="cpu")
        want = jtune_tm(_jref(m), xv, yv, max_sweeps=2, backend="jnp",
                        chain_engine="host")
    assert any("falling back to the numpy" in str(c.message)
               for c in caught)
    assert got.stats["demoted"] == want.stats["demoted"]
    assert got.stats["backend"] == "numpy" == want.stats["backend"]
    _assert_same(got, want, "numpy")


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
def test_gpu_tm_tuner_csd_equals_numpy():
    """On the card ``auto`` is the csd backend and the chain engine the
    ``tm_chain`` kernel, one launch a chain call; the TM tuner's result
    equals the numpy backend's for both scopes, ``stats["candidates"]``
    aside (the device engine counts every nudge of a failed pair), and
    with ``chain_engine="host"`` on csd the whole result does."""
    _needs_card()
    from repro_torch.kernels.chain_scan import tm_chain_kernel
    rng = np.random.default_rng(2)
    ws = [(rng.integers(-40, 41, (16, 16)) * rng.integers(1, 3, (16, 16)))
          .astype(np.int64), (rng.integers(-40, 41, (16, 10)) * 2)
          .astype(np.int64)]
    bs = [rng.integers(-8, 9, 16).astype(np.int64),
          rng.integers(-8, 9, 10).astype(np.int64)]
    m = IntMLP(ws, bs, ["htanh", "hsig"], q=5)
    xv = rng.integers(-128, 128, (2248, 16)).astype(np.int64)
    yv = rng.integers(0, 10, 2248)
    for scope in ("neuron", "ann"):
        n0 = tm_chain_kernel.launches
        got = tune_time_multiplexed(_port(m), xv, yv, scope=scope,
                                    max_sweeps=2)
        assert tm_chain_kernel.launches - n0 == got.stats["eval_calls"]
        host = tune_time_multiplexed(_port(m), xv, yv, scope=scope,
                                     max_sweeps=2, chain_engine="host")
        want = tune_time_multiplexed(_port(m), xv, yv, scope=scope,
                                     max_sweeps=2, backend="numpy",
                                     device="cpu")
        assert got.stats["backend"] == host.stats["backend"] == "csd"
        _assert_same(got, want, "numpy", candidates=False)
        _assert_same(host, want, "numpy")
