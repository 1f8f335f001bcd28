"""The design-space explorer, end to end:
``python -m repro_torch.launch.explore [--device cuda|cpu] [--tuners ...]``.

The counterpart of ``examples/explore_design_space.py``:

1. train a float 16-16-10 ANN on the pendigits surrogate (ZAAL trainer,
   25 epochs, seed 3);
2. ``explore()`` derives a q ladder from the Section IV-A min-q search
   (``q_span=2``), builds the ``(q, tuned/untuned)`` network grid with the
   tuners named by ``--tuners`` (default ``none``, ``parallel`` and
   ``parallel-adders``, ``max_sweeps=3``; ``mixedbw`` adds the per-layer
   mixed-q network), scores the whole grid's hardware accuracy in
   stacked ``QSweepEvaluator`` dispatches and prices every
   ``(arch, style)`` combo on the cost IR;
3. print the Pareto fronts of accuracy against area, energy and latency,
   and the cheapest design within 0, 1 and 3 points of the best accuracy.

On a CUDA device the evaluators default to the ``csd`` backend: the
accuracy axis and the min-q search run through the ``csd_qsweep`` kernel
and the IV-B tuners' polish through ``csd_matvec``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import quantize_inputs
from repro_torch.data import pendigits
from repro_torch.eval.batched import resolve_device
from repro_torch.explore import TUNERS, ExploreResult, explore
from repro_torch.train.zaal import TrainConfig, TrainResult, train

STRUCTURE = (16, 16, 10)
ACTIVATIONS = ("htanh", "hsig")
EPOCHS = 25
SEED = 3
Q_SPAN = 2
MAX_SWEEPS = 3
DEFAULT_TUNERS = ("none", "parallel", "parallel-adders")


def train_float(device="cuda"):
    """Train the float network on ``device``; returns the training result
    and the quantized validation split ``(x_val_int, y_val)``."""
    dev = resolve_device(device)
    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = train(TrainConfig(structure=STRUCTURE, epochs=EPOCHS, seed=SEED),
                pendigits.to_unit(xtr), ytr, pendigits.to_unit(xval), yval,
                device=dev)
    return res, quantize_inputs(pendigits.to_unit(xval)), yval


def run_explore(res: TrainResult, x_val: np.ndarray, y_val: np.ndarray,
                device="cuda", *, tuners=DEFAULT_TUNERS, backend="auto",
                planner=None, evaluator=None) -> ExploreResult:
    """Explore the design space of ``res``'s float weights on ``device``;
    ``backend`` is the tuners' evaluator backend and, unless ``evaluator``
    (a ``QSweepEvaluator`` on the same split) is given, the sweep
    evaluator's."""
    from repro_torch.eval import QSweepEvaluator
    ev = evaluator if evaluator is not None else QSweepEvaluator(
        x_val, y_val, backend=backend, device=device)
    return explore(res.weights, res.biases, ACTIVATIONS, x_val, y_val,
                   q_span=Q_SPAN, tuners=tuple(tuners),
                   max_sweeps=MAX_SWEEPS, evaluator=ev, planner=planner,
                   tune_kwargs={"backend": backend}, device=device)


def report(res: TrainResult, result: ExploreResult) -> None:
    """Print the fronts and the cheapest-within rows, as the reference
    walkthrough does."""
    print(f"   float validation accuracy: {res.val_acc:.1f}%")
    s = result.stats
    print(f"   {s['n_networks']} networks (q ladder {result.qs} x "
          f"{result.tuners}) -> {s['n_points']} priced design points")
    print(f"   accuracy axis: {s['eval_calls']} stacked evaluator "
          f"dispatch(es); cost axis: planner {s['planner_hits']} hits / "
          f"{s['planner_misses']} misses; wall {s['wall_s']:.1f}s "
          f"(tuning {s['tune_s']:.1f}s)")
    for metric, label in [("area_um2", "area (um^2)"),
                          ("energy_pj", "energy (pJ)"),
                          ("latency_ns", "latency (ns)")]:
        front = result.front(metric)
        print(f"== Pareto front: hardware accuracy vs {label} "
              f"({len(front)} of {len(result.points)} points)")
        for p in front:
            print("   " + p.row())
    top = max(p.ha for p in result.points)
    for slack in (0.0, 1.0, 3.0):
        b = result.best("area_um2", min_ha=top - slack)
        print(f"== cheapest design within {slack:.0f}pp of the best accuracy "
              f"({top - slack:.1f}%):")
        print("   " + b.row())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tuners", nargs="+", default=list(DEFAULT_TUNERS),
                    choices=sorted(TUNERS) + ["mixedbw"])
    args = ap.parse_args(argv)
    print("== 1. train a float 16-16-10 ANN (pendigits surrogate)")
    res, x_val, y_val = train_float(args.device)
    print("== 2. sweep the design space (arch x style x q x tuning)")
    report(res, run_explore(res, x_val, y_val, args.device,
                            tuners=args.tuners))


if __name__ == "__main__":
    main()
