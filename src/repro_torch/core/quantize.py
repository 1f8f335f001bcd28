"""Minimum-quantization-value search (paper Section IV-A), the counterpart
of ``repro/core/quantize.py``.

Floating-point weights/biases from training are converted to integers by
``ceil(v * 2^q)``; the search increments q until the hardware accuracy on the
validation split stops improving by more than 0.1 percentage points.

Interpretation note (DESIGN.md 8): the paper's step 5 reads "if ha(q) > 0 and
ha(q) - ha(q-1) > 0.1%, go to step 2".  A literal reading would stop at q=1
whenever the 1-bit network scores 0%; the evident intent is to keep growing q
while the network is still useless OR still improving, so we continue while
``ha(q) <= chance`` or the improvement exceeds the 0.1% budget, capped at
``q_max``.

Engines (DESIGN.md 10): ``engine="batched"`` (the default) quantizes a block
of candidate q levels once and scores them in one stacked integer forward on
the multi-q sweep evaluator (``repro_torch.eval.QSweepEvaluator``), then applies
the stopping rule serially over the exact per-q accuracies — the returned
``(q, ha, history)`` is bit-identical to ``engine="serial"``, the original
one-forward-per-q reference loop.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from .intmlp import IntMLP, hardware_accuracy

__all__ = ["quantize_value", "quantize_mlp", "find_min_q", "QuantResult"]


def quantize_value(v, q: int):
    """ceil(v * 2^q) — the paper's float->int conversion (step 3)."""
    return np.ceil(np.asarray(v, dtype=np.float64) * (1 << q)).astype(np.int64)


def quantize_mlp(weights, biases, activations, q: int) -> IntMLP:
    if len(activations) != len(weights):
        # forward_int zips layers with activations, so a surplus entry
        # SILENTLY drops the output activation (and a short list drops
        # layers).  Seed-era callers relied on the zip, so this only warns;
        # new-surface boundaries (repro.explore) reject it outright.
        warnings.warn(
            f"quantize_mlp: {len(weights)} weight matrices but "
            f"{len(activations)} activations — forward_int zip-truncates, "
            f"so the surplus/missing entries change the realized network",
            stacklevel=2)
    return IntMLP(
        weights=[quantize_value(w, q) for w in weights],
        biases=[quantize_value(b, q) for b in biases],
        activations=list(activations),
        q=q,
    )


@dataclass
class QuantResult:
    q: int
    mlp: IntMLP
    ha: float             # hardware accuracy at q (validation, %)
    history: list         # [(q, ha)] for every q tried


def find_min_q(weights, biases, activations, x_val_int: np.ndarray,
               y_val: np.ndarray, *, budget_pct: float = 0.1,
               q_max: int = 16, chance_pct: float = 0.0,
               engine: str = "batched", backend: str = "auto",
               block: int = 4, shard: bool = False,
               evaluator=None, device="cuda") -> QuantResult:
    """Paper Section IV-A, steps 1-6.

    ``engine="batched"`` scores ``block`` candidate q levels per stacked
    evaluator call with the stopping decisions bit-identical to the serial
    loop (DESIGN.md 10); ``engine="serial"`` is the original reference path.
    Pass ``evaluator`` (a ``repro_torch.eval.QSweepEvaluator`` built on the same
    validation split) to share its padded rows and jitted forwards across
    many searches — the paper-table pipeline's pattern.  A passed evaluator
    carries its own configuration, so it takes precedence over the
    ``backend``/``shard``/``block``/``device`` arguments (blocks follow
    its ``qchunk``).  ``device`` is passed to the evaluator built here; its
    ``backend="auto"`` runs the ``csd`` digit-plane kernel on a CUDA device.
    """
    if engine == "serial":
        return _find_min_q_serial(weights, biases, activations, x_val_int,
                                  y_val, budget_pct=budget_pct, q_max=q_max,
                                  chance_pct=chance_pct)
    if engine != "batched":
        raise ValueError(engine)
    if evaluator is None:
        from repro_torch.eval import QSweepEvaluator
        evaluator = QSweepEvaluator(x_val_int, y_val, backend=backend,
                                    shard=shard, qchunk=block, device=device)
    else:
        block = evaluator.qchunk
    history = []
    prev_ha = 0.0
    q = 0
    best = None
    while q < q_max:
        qs = list(range(q + 1, min(q + block, q_max) + 1))     # step 2 block
        mlps = [quantize_mlp(weights, biases, activations, qq)  # step 3, once
                for qq in qs]
        has = evaluator.evaluate(mlps)                          # step 4 batch
        for qq, mlp, ha in zip(qs, mlps, has):
            history.append((qq, ha))
            best = QuantResult(q=qq, mlp=mlp, ha=ha, history=history)
            if ha > chance_pct and ha - prev_ha <= budget_pct:  # steps 5-6
                return best
            prev_ha = ha
        q = qs[-1]
    return best


def _find_min_q_serial(weights, biases, activations, x_val_int, y_val, *,
                       budget_pct: float, q_max: int,
                       chance_pct: float) -> QuantResult:
    """The seed's one-forward-per-q loop — the sweep engine's reference."""
    history = []
    prev_ha = 0.0
    q = 0
    best = None
    while q < q_max:
        q += 1                                     # step 2
        mlp = quantize_mlp(weights, biases, activations, q)  # step 3
        ha = hardware_accuracy(mlp, x_val_int, y_val)        # step 4
        history.append((q, ha))
        best = QuantResult(q=q, mlp=mlp, ha=ha, history=history)
        if ha > chance_pct and ha - prev_ha <= budget_pct:   # steps 5-6
            return best
        prev_ha = ha
    return best
