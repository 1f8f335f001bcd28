"""The paper slice as a whole against the JAX package on the CPU: from the
same float weights, ``find_min_q`` gives the same ``(q, ha, history)`` and
``tune_parallel(cost="adders")`` the same ``TuneResult`` (weights, biases,
bha, replacements, sweeps, log and every stats entry, the backend label
mapped) on every port backend, and the serial engines agree too."""
import numpy as np
import pytest

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core import find_min_q as jfind_min_q
    from repro.core import tune_parallel as jtune_parallel
    from repro.core.planner import SynthesisPlanner as JPlanner
    from repro.train.zaal import TrainConfig as JTrainConfig
    from repro.train.zaal import train as jtrain
except ImportError:
    jtrain = None
from repro_torch.configs.pendigits_mlp import hw_activations
from repro_torch.core import find_min_q, quantize_inputs, tune_parallel
from repro_torch.core.planner import SynthesisPlanner
from repro_torch.data import pendigits

STRUCTURE = (16, 10, 10, 10)       # three weight layers: csd_matvec runs
N_VAL = 300
LABEL = {"numpy": "numpy", "torch": "jnp", "csd": "pallas"}


@pytest.fixture(scope="module")
def case():
    """Float weights from the reference trainer, the first ``N_VAL``
    validation rows, and planners warmed by one numpy tuning run on each
    side, so that every later run's planner hits and misses agree whatever
    tests run and in what order."""
    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = jtrain(JTrainConfig(structure=STRUCTURE, epochs=15),
                 pendigits.to_unit(xtr), ytr, pendigits.to_unit(xval), yval)
    xval, yval = xval[:N_VAL], yval[:N_VAL]
    xi = quantize_inputs(pendigits.to_unit(xval))
    acts = hw_activations(STRUCTURE)
    qr = find_min_q(res.weights, res.biases, acts, xi, yval,
                    backend="numpy", device="cpu")
    planners = (SynthesisPlanner(), JPlanner())
    warm = _tune_both(qr.mlp, xi, yval, "numpy", planners)
    return dict(w=res.weights, b=res.biases, acts=acts, x=xi, y=yval,
                mlp=qr.mlp, planners=planners, warm=warm)


def _tune_both(mlp, x, y, backend, planners, **kw):
    kw = dict(cost="adders", max_sweeps=2, chunk=16, **kw)
    got = tune_parallel(mlp, x, y, backend=backend, device="cpu",
                        planner=planners[0], **kw)
    want = jtune_parallel(mlp, x, y, backend=LABEL[backend],
                          planner=planners[1], **kw)
    return got, want


def _assert_tune_equal(got, want, backend="numpy"):
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        np.testing.assert_array_equal(a, b)
    assert (got.bha, got.initial_ha, got.replacements, got.sweeps) == \
        (want.bha, want.initial_ha, want.replacements, want.sweeps)
    assert got.log == want.log
    stats = dict(got.stats)
    if "backend" in stats:
        assert stats["backend"] == backend
        stats["backend"] = LABEL[backend]
    assert stats == want.stats


@pytest.mark.parametrize("backend", ["numpy", "torch", "csd"])
def test_find_min_q_equal(case, backend):
    got = find_min_q(case["w"], case["b"], case["acts"], case["x"],
                     case["y"], backend=backend, device="cpu")
    want = jfind_min_q(case["w"], case["b"], case["acts"], case["x"],
                       case["y"], backend=LABEL[backend])
    assert (got.q, got.ha, got.history) == (want.q, want.ha, want.history)
    for a, b in zip(got.mlp.weights, want.mlp.weights):
        np.testing.assert_array_equal(a, b)
    assert len(got.history) >= 3


def test_find_min_q_serial_equal(case):
    got = find_min_q(case["w"], case["b"], case["acts"], case["x"],
                     case["y"], engine="serial")
    want = jfind_min_q(case["w"], case["b"], case["acts"], case["x"],
                       case["y"], engine="serial")
    assert (got.q, got.ha, got.history) == (want.q, want.ha, want.history)


@pytest.mark.parametrize("backend", ["numpy", "torch", "csd"])
def test_tune_parallel_adders_equal(case, backend):
    """The warm-up run (numpy, cold planners) is held too; the polish
    drops digits past the paper's loop and the adder ledger moves."""
    _assert_tune_equal(*case["warm"])
    got, want = _tune_both(case["mlp"], case["x"], case["y"], backend,
                           case["planners"])
    _assert_tune_equal(got, want, backend)
    assert got.stats["adders_final"] <= got.stats["adders_after_drop"]
    assert got.stats["tnzd_final"] < got.stats["tnzd_initial"]


def test_tune_parallel_serial_equal(case):
    """The serial reference loops, with the paper's cost and the priced
    polish, each at one sweep per phase."""
    for cost in ("tnzd", "adders"):
        kw = dict(engine="serial", cost=cost, max_sweeps=1)
        got = tune_parallel(case["mlp"], case["x"], case["y"], **kw)
        want = jtune_parallel(case["mlp"], case["x"], case["y"], **kw)
        _assert_tune_equal(got, want)
