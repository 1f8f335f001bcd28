"""The design-space explorer of repro_torch against the JAX package on the
CPU, with no tolerance: the Pareto mechanics on ``test_explore.py``'s
synthetic points, and ``explore()`` on ``test_explore.py::explored``'s
network with all five ported tuner variants and a fresh planner on each
side (every ``DesignPoint``, the fronts and the non-timing stats equal).
On the card (``gpu`` marker) the explorer on ``csd`` equals ``numpy``."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core.planner import SynthesisPlanner as JPlanner
    from repro.explore import explore as jexplore
    from repro.explore import pareto as jpareto
except ImportError:
    jexplore = None
from repro_torch.core.planner import SynthesisPlanner
from repro_torch.explore import (TUNERS, dominates, explore, is_pareto_front,
                                 pareto_front)
from repro_torch.kernels.csd_matvec import csd_qsweep_kernel

ALL_TUNERS = ("none", "parallel", "parallel-adders", "tm-neuron", "tm-ann")
TIMINGS = ("tune_s", "wall_s")
METRICS = ("area_um2", "energy_pj", "latency_ns", "n_adders",
           "weight_bytes")


def _pt(cost, acc):
    return {"cost": cost, "acc": acc}


_C = lambda p: p["cost"]            # noqa: E731
_A = lambda p: p["acc"]             # noqa: E731


def _synthetic():
    rng = np.random.default_rng(0)
    return [[_pt(3, 50), _pt(1, 10), _pt(2, 50), _pt(2, 30), _pt(5, 60),
             _pt(1, 10), _pt(4, 55)],
            [_pt(1, 10), _pt(2, 50), _pt(3, 40)],
            [_pt(int(c), int(a)) for c, a in
             zip(rng.integers(0, 40, 120), rng.integers(0, 40, 120))]]


def test_pareto_equals_reference():
    for pts in _synthetic():
        front = pareto_front(pts, cost=_C, acc=_A)
        want = jpareto.pareto_front(pts, cost=_C, acc=_A)
        assert [id(p) for p in front] == [id(p) for p in want]
        assert is_pareto_front(front, pts, cost=_C, acc=_A)
        for sub in (front[:1], front[1:], pts[:2]):
            assert is_pareto_front(sub, pts, cost=_C, acc=_A) == \
                jpareto.is_pareto_front(sub, pts, cost=_C, acc=_A)
        for p in pts[:12]:
            for q in pts[:12]:
                args = (_C(p), _A(p), _C(q), _A(q))
                assert dominates(*args) == jpareto.dominates(*args)


def _explored_inputs():
    """``test_explore.py::explored``'s float network and split."""
    rng = np.random.default_rng(1)
    w1 = rng.normal(0, 0.5, (16, 12)); b1 = rng.normal(0, 0.2, 12)
    w2 = rng.normal(0, 0.5, (12, 10)); b2 = rng.normal(0, 0.2, 10)
    xv = rng.integers(-128, 128, (400, 16)).astype(np.int64)
    yv = rng.integers(0, 10, 400)
    return [w1, w2], [b1, b2], ("htanh", "hsig"), xv, yv


def _rows(points):
    """DesignPoints as field tuples (the two packages' classes differ)."""
    return [astuple(p) for p in points]


def _assert_same_result(got, want):
    assert _rows(got.points) == _rows(want.points)   # every field, ==
    assert (got.qs, got.tuners) == (want.qs, want.tuners)
    for metric in METRICS:
        assert _rows(got.front(metric)) == _rows(want.front(metric)), metric
    assert {k: v for k, v in got.stats.items() if k not in TIMINGS} == \
        {k: v for k, v in want.stats.items() if k not in TIMINGS}
    top = max(p.ha for p in got.points)
    for slack in (0.0, 1.0, 3.0):
        assert _rows([got.best("area_um2", min_ha=top - slack)]) == \
            _rows([want.best("area_um2", min_ha=top - slack)])


@pytest.fixture(scope="module")
def explored():
    ws, bs, acts, xv, yv = _explored_inputs()
    got = explore(ws, bs, acts, xv, yv, qs=(3, 4), tuners=ALL_TUNERS,
                  max_sweeps=1, planner=SynthesisPlanner(), device="cpu")
    want = jexplore(ws, bs, acts, xv, yv, qs=(3, 4), tuners=ALL_TUNERS,
                    max_sweeps=1, planner=JPlanner(),
                    tune_kwargs={"backend": "numpy"})
    return got, want


def test_explore_equals_reference(explored):
    """The port's defaults on the CPU (sweep evaluator ``numpy``, tuners
    ``torch``) against the reference on ``numpy``: same points, fronts,
    cheapest-within rows and non-timing stats."""
    got, want = explored
    _assert_same_result(got, want)
    assert len(got.points) == 2 * len(ALL_TUNERS) * 7
    assert got.stats["n_networks"] == 10
    assert set(got.stats) == set(want.stats)
    assert all(got.stats[k] >= 0.0 for k in TIMINGS)
    for p in got.points:
        assert isinstance(p.row(), str) and "area=" in p.row()


def test_explore_tuned_variants_differ(explored):
    """Every tuner moved its network away from the untuned one somewhere
    on the grid, so the comparison above holds real tuner output."""
    got, _ = explored
    nets = {}
    for p in got.points:
        nets.setdefault(p.tuner, set()).add((p.q, p.tnzd, p.ha, p.area_um2))
    for name in ALL_TUNERS[1:]:
        assert nets[name] != nets["none"], name


def test_explore_derives_q_ladder_equal():
    """Without ``qs`` the ladder comes from the min-q search on the shared
    evaluator, as in the reference."""
    rng = np.random.default_rng(3)
    w = [rng.normal(0, 0.6, (8, 5)), rng.normal(0, 0.6, (5, 4))]
    b = [rng.normal(0, 0.2, 5), rng.normal(0, 0.2, 4)]
    xv = rng.integers(-128, 128, (200, 8)).astype(np.int64)
    yv = rng.integers(0, 4, 200)
    got = explore(w, b, ("htanh", "hsig"), xv, yv, q_span=1,
                  tuners=("none", "tm-ann"), planner=SynthesisPlanner(),
                  device="cpu")
    want = jexplore(w, b, ("htanh", "hsig"), xv, yv, q_span=1,
                    tuners=("none", "tm-ann"), planner=JPlanner())
    _assert_same_result(got, want)
    assert len(got.qs) == 2


def test_explore_rejections():
    rng = np.random.default_rng(0)
    w = [rng.normal(0, 1, (8, 5)), rng.normal(0, 1, (5, 3))]
    b = [rng.normal(0, 1, 5), rng.normal(0, 1, 3)]
    xv = rng.integers(-128, 128, (10, 8)).astype(np.int64)
    yv = rng.integers(0, 3, 10)
    with pytest.raises(ValueError, match="activations"):
        explore(w, b, ("htanh", "htanh", "hsig"), xv, yv, qs=(3,),
                tuners=("none",), device="cpu")
    with pytest.raises(ValueError):
        explore(w, b, ("htanh", "hsig"), xv, yv, qs=(3,),
                tuners=("none", "magic"), device="cpu")
    with pytest.raises(ValueError, match="unknown tuner"):
        explore(w, b, ("htanh", "hsig"), xv, yv, qs=(3,),
                tuners=("mixedbw", "mixed"), device="cpu")
    assert set(TUNERS) == set(ALL_TUNERS)


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
def test_gpu_explore_csd_equals_numpy():
    """On the card the explorer's default evaluator is the csd backend, its
    sweep runs through the ``csd_qsweep`` kernel, and every point, front
    and non-timing stat equals the numpy backend's."""
    _needs_card()
    from repro_torch.eval import QSweepEvaluator
    ws, bs, acts, xv, yv = _explored_inputs()
    n0 = csd_qsweep_kernel.launches
    got = explore(ws, bs, acts, xv, yv, q_span=1, tuners=ALL_TUNERS,
                  max_sweeps=1, planner=SynthesisPlanner())
    assert csd_qsweep_kernel.launches > n0
    want = explore(ws, bs, acts, xv, yv, q_span=1, tuners=ALL_TUNERS,
                   max_sweeps=1, planner=SynthesisPlanner(),
                   evaluator=QSweepEvaluator(xv, yv, backend="numpy",
                                             device="cpu"),
                   tune_kwargs={"backend": "numpy"}, device="cpu")
    _assert_same_result(got, want)
