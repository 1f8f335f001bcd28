"""repro_torch.eval against repro.eval on the CPU, exactly: the sweep
engine's counts on every backend (with networks that demote), and the
mutation engine's independent, prefix and chain scores, its commits and its
demotion.  The port's backends ``numpy``/``torch``/``csd`` stand for the
reference's ``numpy``/``jnp``/``pallas`` (Pallas in interpret mode here)."""
import warnings

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core.intmlp import IntMLP as JIntMLP
    from repro.core.quantize import quantize_mlp as jquantize_mlp
    from repro.eval import BatchedHWEvaluator as JBatched
    from repro.eval import Candidate as JCandidate
    from repro.eval import QSweepEvaluator as JQSweep
except ImportError:
    JBatched = None
from repro_torch.core.intmlp import IntMLP, hardware_accuracy
from repro_torch.core.quantize import quantize_mlp
from repro_torch.eval import (BatchedHWEvaluator, Candidate, QSweepEvaluator,
                              csd_net_int32_safe, int32_safe_bound,
                              net_int32_safe)
from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                            csd_qsweep_kernel)

BACKENDS = [("numpy", "numpy"), ("torch", "jnp"), ("csd", "pallas")]
IDS = [b for b, _ in BACKENDS]


def _float_net(rng, structure):
    ws = [rng.normal(0, 0.6, size=(a, b))
          for a, b in zip(structure[:-1], structure[1:])]
    bs = [rng.normal(0, 0.3, size=b) for b in structure[1:]]
    return ws, bs


def _rand_case(rng, structure, acts, q, m=211):
    ws = [rng.integers(-(1 << (q + 1)), 1 << (q + 1), (a, b)).astype(np.int64)
          for a, b in zip(structure[:-1], structure[1:])]
    bs = [rng.integers(-(1 << q), 1 << q, (b,)).astype(np.int64)
          for b in structure[1:]]
    x = rng.integers(-128, 128, (m, structure[0])).astype(np.int64)
    y = rng.integers(0, structure[-1], m)
    return ws, bs, list(acts), q, x, y


def _pair(ws, bs, acts, q):
    """The same network as a port IntMLP and a reference IntMLP."""
    return (IntMLP([w.copy() for w in ws], [b.copy() for b in bs],
                   list(acts), q),
            JIntMLP([w.copy() for w in ws], [b.copy() for b in bs],
                    list(acts), q))


def _cands(rng, mlp, k, q, n):
    n_in, n_o = mlp.weights[k].shape
    pool = [(i, j) for i in range(n_in) for j in range(n_o)]
    rng.shuffle(pool)
    return [(k, j, i, int(rng.integers(-(1 << (q + 1)), 1 << (q + 1))),
             int(rng.integers(-4, 5))) for (i, j) in pool[:n]]


def _both(spec):
    return [Candidate(*c) for c in spec], [JCandidate(*c) for c in spec]


def _assert_state_equal(ev, jev):
    assert ev.accuracy() == jev.accuracy()
    for a, b in zip(ev.mlp.weights + ev.mlp.biases,
                    jev.mlp.weights + jev.mlp.biases):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ev._a + ev._acc, jev._a + jev._acc):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ sweep engine

@pytest.mark.parametrize("backend,jbackend", BACKENDS, ids=IDS)
def test_qsweep_counts_equal(backend, jbackend):
    """Counts of a q sweep on every backend, q levels from 1-bit to past
    every exactness tier, so that some networks of a batch demote (int32
    bounds) and the host reaches its float32, float64 and int64 tiers."""
    rng = np.random.default_rng(11)
    ws, bs = _float_net(rng, (16, 16, 10, 10))
    acts = ("htanh", "satlin", "hsig")
    x = rng.integers(-128, 128, (173, 16)).astype(np.int64)
    y = rng.integers(0, 10, 173)
    qs = [1, 2, 3, 5, 8, 19, 20, 21, 23, 50]
    mlps = [quantize_mlp(ws, bs, acts, q) for q in qs]
    jmlps = [jquantize_mlp(ws, bs, acts, q) for q in qs]
    is_safe = csd_net_int32_safe if backend == "csd" else net_int32_safe
    assert 0 < sum(map(is_safe, mlps)) < len(mlps)
    ev = QSweepEvaluator(x, y, backend=backend, device="cpu")
    jev = JQSweep(x, y, backend=jbackend)
    assert ev.backend == backend and jev.backend == jbackend
    got, want = ev.counts(mlps), jev.counts(jmlps)
    np.testing.assert_array_equal(got, want)
    assert ev.evaluate(mlps[:3]) == jev.evaluate(jmlps[:3])
    assert ev.stats == jev.stats
    assert [int(c) for c in got] == [
        round(hardware_accuracy(m, x, y) * 173 / 100) for m in mlps]


def test_qsweep_auto_and_guards():
    x, y = np.zeros((4, 3), np.int64), np.zeros(4, np.int64)
    assert QSweepEvaluator(x, y, device="cpu").backend == "numpy"
    with pytest.raises(NotImplementedError):
        QSweepEvaluator(x, y, shard=True, device="cpu")
    with pytest.raises(ValueError):
        QSweepEvaluator(x, y, backend="jnp", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QSweepEvaluator(x, y)


# --------------------------------------------------------- mutation engine

@pytest.mark.parametrize("backend,jbackend", BACKENDS, ids=IDS)
@pytest.mark.parametrize("structure,acts", [
    ((16, 10, 10, 10), ("htanh", "satlin", "hsig")),   # csd dense tail at k=0
    ((8, 6, 5, 5, 4), ("relu", "htanh", "lin", "hsig")),
], ids=["3-layer", "4-layer"])
def test_mutation_engine_equal(structure, acts, backend, jbackend):
    """evaluate / evaluate_prefix / evaluate_chain on every layer, then
    commits and a commit run: every score, decision, cache and counter
    equals the reference's."""
    rng = np.random.default_rng(len(structure))
    ws, bs, acts, q, x, y = _rand_case(rng, structure, acts, 5)
    m, jm = _pair(ws, bs, acts, q)
    ev = BatchedHWEvaluator(m, x, y, backend=backend, chunk=16, device="cpu")
    jev = JBatched(jm, x, y, backend=jbackend, chunk=16)
    assert ev.backend == backend
    _assert_state_equal(ev, jev)
    for k in range(len(ws)):
        cands, jcands = _both(_cands(rng, m, k, q, 21))
        assert ev.evaluate(cands) == jev.evaluate(jcands)
        assert ev.evaluate_prefix(cands[:7]) == jev.evaluate_prefix(jcands[:7])
        bha = ev.accuracy()
        assert ev.evaluate_chain(cands[:16], bha) == \
            jev.evaluate_chain(jcands[:16], bha)
    for k in (0, len(ws) - 1, 1):
        c, jc = _both(_cands(rng, ev.mlp, k, q, 1))
        ev.commit(c[0])
        jev.commit(jc[0])
        _assert_state_equal(ev, jev)
        probe, jprobe = _both(_cands(rng, ev.mlp, 0, q, 5))
        assert ev.evaluate(probe) == jev.evaluate(jprobe)
    run, jrun = _both(_cands(rng, ev.mlp, 0, q, 6))
    ev.commit_many(run)
    jev.commit_many(jrun)
    _assert_state_equal(ev, jev)
    probe, jprobe = _both(_cands(rng, ev.mlp, 0, q, 9))
    assert ev.evaluate(probe) == jev.evaluate(jprobe)
    assert ev.stats == jev.stats


def test_csd_tail_runs_the_digit_plane_path():
    """On the csd backend a 3-layer net's layer-0 candidates reach the
    dense tail and so the digit-plane matvec (the plain version on the
    CPU); the plane cache is dropped on a commit of its layer only."""
    rng = np.random.default_rng(5)
    ws, bs, acts, q, x, y = _rand_case(rng, (16, 10, 10, 10),
                                       ("htanh", "htanh", "hsig"), 4, m=50)
    ev = BatchedHWEvaluator(IntMLP(ws, bs, acts, q), x, y, backend="csd",
                            device="cpu")
    cands, _ = _both(_cands(rng, ev.mlp, 0, q, 4))
    ev.evaluate(cands)
    state = ev._dev
    planes = state._planes[2]
    assert planes is not None and planes.dtype == torch.int8
    ev.evaluate(cands)
    assert state._planes[2] is planes            # uploaded once, reused
    ev.commit(Candidate(1, 0, 0, 3))
    assert state._planes[2] is planes
    ev.commit(Candidate(2, 0, 0, 3))
    assert state._planes[2] is None              # its layer changed


@pytest.mark.parametrize("backend,jbackend", BACKENDS[1:], ids=IDS[1:])
def test_mutation_demotion_equal(backend, jbackend):
    """Weights past the int32 accumulator bound demote both engines to
    int64 numpy, with the same recorded reason, and stay exact."""
    rng = np.random.default_rng(9)
    ws = [np.full((8, 6), 1 << 24, dtype=np.int64),
          rng.integers(-3, 4, (6, 5)), rng.integers(-3, 4, (5, 4))]
    bs = [np.zeros(6, np.int64), np.zeros(5, np.int64), np.zeros(4, np.int64)]
    m, jm = _pair(ws, bs, ["htanh", "htanh", "hsig"], 20)
    assert not int32_safe_bound(m)
    x = rng.integers(-128, 128, (50, 8)).astype(np.int64)
    y = rng.integers(0, 4, 50)
    with pytest.warns(UserWarning, match="numpy"):
        ev = BatchedHWEvaluator(m, x, y, backend=backend, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jev = JBatched(jm, x, y, backend=jbackend)
    assert ev.backend == jev.backend == "numpy"
    cands, jcands = _both([(0, 2, 3, 12345, 0), (1, 1, 1, 2, 1)])
    assert ev.evaluate(cands[:1]) == jev.evaluate(jcands[:1])
    assert ev.stats == jev.stats and "demoted" in ev.stats


def test_mutation_auto_and_guards():
    rng = np.random.default_rng(3)
    ws, bs, acts, q, x, y = _rand_case(rng, (8, 6, 4), ("htanh", "hsig"), 3)
    ev = BatchedHWEvaluator(IntMLP(ws, bs, acts, q), x, y, device="cpu")
    assert ev.backend == "torch"
    with pytest.raises(NotImplementedError):
        BatchedHWEvaluator(ev.mlp, x, y, shard=True, device="cpu")
    with pytest.raises(ValueError):
        BatchedHWEvaluator(ev.mlp, x, y, backend="pallas", device="cpu")


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
def test_gpu_engines_equal_numpy():
    """On the card, ``auto`` is the csd backend for both engines; every
    count equals the numpy backend's, and both kernels launch."""
    _needs_card()
    rng = np.random.default_rng(21)
    ws, bs = _float_net(rng, (16, 16, 10, 10))
    acts = ("htanh", "htanh", "hsig")
    x = rng.integers(-128, 128, (2248, 16)).astype(np.int64)
    y = rng.integers(0, 10, 2248)
    mlps = [quantize_mlp(ws, bs, acts, q) for q in range(1, 9)]
    ev = QSweepEvaluator(x, y)
    assert ev.backend == "csd"
    n0 = csd_qsweep_kernel.launches
    np.testing.assert_array_equal(
        ev.counts(mlps), QSweepEvaluator(x, y, backend="numpy").counts(mlps))
    assert csd_qsweep_kernel.launches > n0
    ev = BatchedHWEvaluator(mlps[4], x, y)
    ref = BatchedHWEvaluator(mlps[4], x, y, backend="numpy")
    assert ev.backend == "csd"
    n0 = csd_matvec_kernel.launches
    for k in range(3):
        cands, _ = _both(_cands(rng, ev.mlp, k, 5, 100))
        assert ev.evaluate(cands) == ref.evaluate(cands)
        assert ev.evaluate_prefix(cands[:20]) == \
            ref.evaluate_prefix(cands[:20])
        ev.commit(cands[0])
        ref.commit(cands[0])
        assert ev.accuracy() == ref.accuracy()
    assert csd_matvec_kernel.launches > n0
