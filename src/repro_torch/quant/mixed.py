"""Per-matmul mixed bit-width searches (paper IV-A at layer granularity),
the counterpart of ``repro/quant/mixed.py``.

The paper's minimum-quantization loop picks ONE rung for the whole
network.  These searches pick one per weight matrix, greedily: start every
layer at the global min-q rung, each round score EVERY one-layer demotion,
demote the layer whose candidate scores best, and accept while the budget
holds.  Two problem adapters share that core:

* :func:`mixed_bitwidth_search` -- the LM zoo.  Layers are the matmul
  paths of ``quantize_tree``; a candidate is a mixed ``{path: bits}`` qtree
  scored by ``eval_fn`` on its dequantized tree.  The result carries the
  mixed qtree (servable as it is: ``dequant`` reads each leaf's scheme),
  the per-path bits and a priced :class:`ServingCostSheet`.
* :func:`mixed_minq_search` -- the pendigits ``IntMLP``.  A layer at rung
  ``qk`` embeds in the global-``q*`` network as
  ``quantize_value(w, qk) << (q* - qk)``, bit-identical to native ``qk``
  arithmetic (``act_requant``'s clamp, shift and hsig commute with the
  left shift), so every candidate is a plain ``IntMLP`` at ``q*`` and a
  ``QSweepEvaluator`` scores a round in one stacked forward (the
  ``csd_qsweep`` kernel on the card).

Both keep ``engine="serial"``, which scores the same candidates one at a
time; decisions and histories are identical across engines.  Candidates
of the LM search are dequantized one at a time, as the batched
``min_bitwidth_search`` scores its rungs: the reference holds a round's
dequantized trees together, which at full width is 2.1 GB each.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.hwmodel import ServingCostSheet
from repro_torch.core.intmlp import IntMLP, hardware_accuracy
from repro_torch.core.quantize import (QuantResult, find_min_q, quantize_mlp,
                                       quantize_value)

from .ptq import (_eval_many_default, _flatten, _is_qleaf, _map_with_path,
                  dequant, min_bitwidth_search, quantizable_paths,
                  quantize_tree, serving_ledger)

__all__ = ["MixedBitwidthResult", "MixedQResult", "mixed_bitwidth_search",
           "mixed_minq_search", "intmlp_serving_sheet"]


# ---------------------------------------------------------------------------
# LM adapter: per-matmul bits over the PoT qtree
# ---------------------------------------------------------------------------

@dataclass
class MixedBitwidthResult:
    """Outcome of the greedy per-matmul search on an LM param tree."""
    bits: dict            # path -> chosen bitwidth
    qtree: object         # mixed qtree (each qleaf carries its own bits)
    base: float           # float-baseline loss
    loss: float           # loss at the accepted assignment
    start_bits: int       # the global min-q rung every layer started at
    history: list         # [(round, [(path, bits, loss), ...], picked, ok)]
    sheet: ServingCostSheet = field(repr=False, default=None)


def _qleaves_by_path(qt) -> dict:
    return {"/".join(path): leaf for path, leaf in _flatten(qt)
            if _is_qleaf(leaf)}


def _assemble(params, rung, leafcache, ladder):
    """Mixed qtree for one rung assignment, from the per-rung leaf caches
    (float leaves and cached qleaves shared, not copied)."""
    def pick(key, leaf):
        if key not in rung:
            return leaf
        return leafcache[ladder[rung[key]]][key]
    return _map_with_path(pick, params)


def _mean_eval_fn(fns):
    """Calibration-set scoring: a SEQUENCE of eval_fns (one per
    calibration batch) collapses to the ``np.mean`` of their losses, in
    the sequence's order.  The reference's stacked scorer computes the
    same per-batch floats and reduces them the same way, so one callable
    serves both engines."""
    fns = list(fns)

    def eval_one(tree):
        return float(np.mean([float(f(tree)) for f in fns]))
    return eval_one


def mixed_bitwidth_search(params, eval_fn, *, budget: float = 0.01,
                          bit_ladder=(8, 6, 5, 4), engine: str = "batched",
                          eval_many=None, act_itemsize: float = 2.0,
                          score_dtype=torch.float32) -> MixedBitwidthResult:
    """Greedy per-matmul bitwidth assignment under a relative loss budget.

    Start = the global :func:`min_bitwidth_search` rung (same engine); each
    round scores every one-layer-demotion candidate -- ``engine="batched"``
    through ``eval_many`` (default: ``eval_fn`` on each tree of a lazy
    iterable), ``engine="serial"`` one ``eval_fn`` call per candidate over
    the SAME set -- demotes the cheapest-loss layer (first index wins
    ties), and stops when the best candidate breaks ``base * (1 +
    budget)``.  Candidates dequantize at ``score_dtype``, one at a time.

    ``eval_fn`` may be a SEQUENCE of eval callables -- a calibration set
    -- in which case every candidate (and the float baseline) is scored on
    the MEAN loss across the set.
    """
    if engine not in ("serial", "batched"):
        raise ValueError(engine)
    if isinstance(eval_fn, (list, tuple)):
        eval_fn = _mean_eval_fn(eval_fn)
    ladder = list(bit_ladder)
    base = float(eval_fn(params))
    thresh = base * (1.0 + budget)

    _, start_bits, g_hist = min_bitwidth_search(
        params, eval_fn, budget=budget, bit_ladder=bit_ladder,
        engine=engine, eval_many=eval_many)
    start_idx = ladder.index(start_bits)
    cur_loss = dict(h for h in g_hist if h[0] != "float")[start_bits]

    paths = quantizable_paths(params)
    # quantize each remaining rung ONCE; candidates assemble from the cache
    leafcache = {b: _qleaves_by_path(quantize_tree(params, bits=b))
                 for b in ladder[start_idx:]}
    if engine == "batched" and eval_many is None:
        eval_many = _eval_many_default(eval_fn)

    rung = {p: start_idx for p in paths}
    history = []
    rnd = 0
    while True:
        movable = [p for p in paths if rung[p] + 1 < len(ladder)]
        if not movable:
            break
        deqs = (dequant(_assemble(params, {**rung, p: rung[p] + 1},
                                  leafcache, ladder), dtype=score_dtype)
                for p in movable)
        if engine == "batched":
            losses = [float(x) for x in eval_many(deqs)]
        else:
            losses = [float(eval_fn(t)) for t in deqs]
        best = int(np.argmin(losses))          # first index wins ties
        picked = movable[best]
        ok = losses[best] <= thresh
        history.append((rnd, [(p, ladder[rung[p] + 1], loss)
                              for p, loss in zip(movable, losses)],
                        picked, ok))
        if not ok:                             # best violates => all violate
            break
        rung[picked] += 1
        cur_loss = losses[best]
        rnd += 1

    bits = {p: ladder[rung[p]] for p in paths}
    qtree = _assemble(params, rung, leafcache, ladder)
    sheet = serving_ledger(params, bits=bits, act_itemsize=act_itemsize,
                           meta={"base_loss": base, "loss": cur_loss,
                                 "budget": budget, "start_bits": start_bits,
                                 "engine": engine})
    return MixedBitwidthResult(bits=bits, qtree=qtree, base=base,
                               loss=cur_loss, start_bits=start_bits,
                               history=history, sheet=sheet)


# ---------------------------------------------------------------------------
# Pendigits adapter: per-layer q over the IntMLP, shift-embedded at q*
# ---------------------------------------------------------------------------

@dataclass
class MixedQResult:
    """Outcome of the greedy per-layer q search on a trained float MLP."""
    qs: list              # chosen q per layer
    mlp: IntMLP           # mixed network, embedded at the global q*
    ha: float             # hardware accuracy at the accepted assignment
    base_ha: float        # accuracy at the uniform q* start
    q_star: int           # global min-q rung (find_min_q)
    history: list         # [(round, [(layer, q, ha), ...], picked, ok)]
    sheet: ServingCostSheet = field(repr=False, default=None)


def _embed_layer(w, b, qk: int, q_star: int):
    """Quantize one layer at rung ``qk`` and left-shift into the global
    ``q*`` scale -- bit-identical to native ``qk`` arithmetic under the
    global ``act_requant`` (clamp/shift/hsig commute with ``<< d``)."""
    d = q_star - qk
    return quantize_value(w, qk) << d, quantize_value(b, qk) << d


def _effective_bits(w, b) -> int:
    """Sign-magnitude bits of a layer after normalizing the common trailing
    zeros (which is exactly the embedding shift for mixed layers)."""
    vals = np.concatenate([np.abs(np.asarray(w)).ravel(),
                           np.abs(np.asarray(b)).ravel()])
    m = int(vals.max(initial=0))
    if m == 0:
        return 1
    nz = vals[vals > 0]
    tz = min(int(v) & -int(v) for v in nz).bit_length() - 1
    return 1 + (m >> tz).bit_length()


def intmlp_serving_sheet(mlp: IntMLP, *, act_itemsize: float = 1.0,
                         meta: dict | None = None) -> ServingCostSheet:
    """Price an (optionally mixed) ``IntMLP`` as a serving ledger: per-layer
    effective bits after trailing-zero normalization, so a layer embedded at
    ``q*`` but quantized at ``qk < q*`` prices at its native width."""
    sheet = ServingCostSheet(meta=dict(meta or {}))
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        bits = _effective_bits(w, b)
        sheet.add_layer(f"layer{i}", bits=bits, k=int(w.shape[0]),
                        n=int(w.shape[1]), act_itemsize=act_itemsize)
        sheet.extra_bytes += b.size * bits / 8.0       # bias at layer width
    return sheet


def _mean_ha(cands, engine, evaluators, xs, ys):
    """Calibration-set scoring for the IntMLP adapter: mean hardware
    accuracy of each candidate across the batches, per-batch values computed
    by the stacked evaluator (``batched``) or ``hardware_accuracy``
    (``serial``) -- bit-identical per batch, identically reduced."""
    if engine == "batched":
        per = [[float(h) for h in ev.evaluate(cands)] for ev in evaluators]
    else:
        per = [[float(hardware_accuracy(m, x, y)) for m in cands]
               for x, y in zip(xs, ys)]
    return [float(np.mean([p[i] for p in per])) for i in range(len(cands))]


def _find_min_q_mean(weights, biases, activations, xs, ys, *,
                     budget_pct: float = 0.1, q_max: int = 16,
                     chance_pct: float = 0.0, engine: str = "batched",
                     evaluators=None) -> QuantResult:
    """``find_min_q``'s stopping walk, scored on the calibration-set MEAN
    accuracy.  The walk is serial over q (the stop rule chains ha(q) to
    ha(q-1)); each q is scored through :func:`_mean_ha`."""
    history = []
    prev_ha = 0.0
    best = None
    for q in range(1, q_max + 1):
        mlp = quantize_mlp(weights, biases, activations, q)
        ha = _mean_ha([mlp], engine, evaluators, xs, ys)[0]
        history.append((q, ha))
        best = QuantResult(q=q, mlp=mlp, ha=ha, history=history)
        if ha > chance_pct and ha - prev_ha <= budget_pct:
            return best
        prev_ha = ha
    return best


def mixed_minq_search(weights, biases, activations, x_val_int, y_val, *,
                      budget_pct: float = 0.1, q_min: int = 1,
                      engine: str = "batched", backend: str = "auto",
                      evaluator=None, find_kwargs: dict | None = None,
                      device="cuda") -> MixedQResult:
    """Greedy per-layer minimum-q under an absolute accuracy budget.

    Start = the uniform :func:`find_min_q` rung ``q*`` (the paper's IV-A
    network); each round scores every one-layer ``q - 1`` demotion -- all
    candidates in one ``QSweepEvaluator.evaluate`` stacked forward
    (``engine="batched"``) or one ``hardware_accuracy`` call per candidate
    (``engine="serial"``) -- demotes the layer whose candidate keeps the
    MOST accuracy (first index wins ties), and accepts while ``ha >=
    ha(q*) - budget_pct``.

    ``x_val_int``/``y_val`` may be SEQUENCES of validation batches -- a
    calibration set -- scored on the MEAN accuracy (``evaluator`` may then
    be a matching sequence of ``QSweepEvaluator``s).  A passed
    ``evaluator`` wins; otherwise the evaluators are built on ``device``
    with ``backend`` (``auto``: the ``csd`` kernel on a CUDA device).
    """
    if engine not in ("serial", "batched"):
        raise ValueError(engine)
    multi = isinstance(x_val_int, (list, tuple))
    evaluators = None
    if multi:
        xs, ys = list(x_val_int), list(y_val)
        if engine == "batched":
            if evaluator is None:
                from repro_torch.eval import QSweepEvaluator
                evaluators = [QSweepEvaluator(x, y, backend=backend,
                                              device=device)
                              for x, y in zip(xs, ys)]
            else:
                evaluators = list(evaluator)
        qr = _find_min_q_mean(weights, biases, activations, xs, ys,
                              engine=engine, evaluators=evaluators,
                              **(find_kwargs or {}))
    else:
        qr = find_min_q(weights, biases, activations, x_val_int, y_val,
                        engine=engine, backend=backend, evaluator=evaluator,
                        device=device, **(find_kwargs or {}))
    q_star, base_ha = qr.q, qr.ha
    floor = base_ha - budget_pct
    n_layers = len(weights)

    if not multi and evaluator is None and engine == "batched":
        from repro_torch.eval import QSweepEvaluator
        evaluator = QSweepEvaluator(x_val_int, y_val, backend=backend,
                                    device=device)

    # per-(layer, q) embedded integer weights, computed once
    cache = {}

    def layer_at(l: int, qk: int):
        if (l, qk) not in cache:
            cache[(l, qk)] = _embed_layer(weights[l], biases[l], qk, q_star)
        return cache[(l, qk)]

    def network(qs):
        ws, bs = zip(*(layer_at(i, qs[i]) for i in range(n_layers)))
        return IntMLP(list(ws), list(bs), list(activations), q_star)

    qs = [q_star] * n_layers
    history = []
    rnd = 0
    cur_ha = base_ha
    while True:
        movable = [l for l in range(n_layers) if qs[l] > q_min]
        if not movable:
            break
        cands = [network([q - (i == l) for i, q in enumerate(qs)])
                 for l in movable]
        if multi:
            has = _mean_ha(cands, engine, evaluators, xs, ys)
        elif engine == "batched":
            has = list(evaluator.evaluate(cands))
        else:
            has = [hardware_accuracy(m, x_val_int, y_val) for m in cands]
        best = int(np.argmax(has))             # first index wins ties
        picked = movable[best]
        ok = has[best] >= floor
        history.append((rnd, [(l, qs[l] - 1, ha)
                              for l, ha in zip(movable, has)],
                        picked, ok))
        if not ok:
            break
        qs[picked] -= 1
        cur_ha = has[best]
        rnd += 1

    mlp = network(qs)
    sheet = intmlp_serving_sheet(mlp, meta={"qs": list(qs), "q_star": q_star,
                                            "ha": cur_ha, "base_ha": base_ha,
                                            "engine": engine})
    return MixedQResult(qs=list(qs), mlp=mlp, ha=cur_ha, base_ha=base_ha,
                        q_star=q_star, history=history, sheet=sheet)
