"""Batched design-space explorer (DESIGN.md 12.4), the counterpart of
``repro/explore/space.py``.

The paper's headline story is a *joint* trade: quantization level, weight
tuning, design architecture and multiplierless style all move hardware cost
and hardware accuracy together, and the interesting answers live on the
accuracy-vs-cost Pareto front.  :func:`explore` sweeps the full grid

    (arch x style)  x  q ladder  x  {untuned, tuned variants}

in batched dispatches:

* the **accuracy axis** runs on one shared
  :class:`~repro_torch.eval.QSweepEvaluator`: every variant of the sweep
  shares a structure and activations, so all of them score in stacked
  whole-network forwards (the multi-q sweep mode, DESIGN.md 10; the
  ``csd_qsweep`` kernel on the card), one ``counts`` call for the entire
  grid;
* the **cost axis** runs on the vectorized cost IR
  (``archs.design_cost(engine="array")``, DESIGN.md 12.1-12.2) against a
  warm shared :class:`~repro_torch.core.planner.SynthesisPlanner`, on the
  host in float64.

The result carries every priced :class:`DesignPoint` plus Pareto fronts per
cost metric; ``repro_torch.launch.explore`` is the walkthrough.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core import csd
from repro_torch.core.archs import ARCH_STYLES, DesignReport, design_cost
from repro_torch.core.hwmodel import TECH40
from repro_torch.core.intmlp import IntMLP
from repro_torch.core.planner import default_planner
from repro_torch.core.quantize import find_min_q, quantize_mlp
from repro_torch.core.tuning import tune_parallel, tune_time_multiplexed

__all__ = ["DesignPoint", "ExploreResult", "explore", "TUNERS"]

#: The tuned/untuned axis: variant name -> tuner (None = untuned).
TUNERS = {
    "none": None,
    "parallel": lambda mlp, x, y, kw: tune_parallel(mlp, x, y, **kw),
    "parallel-adders": lambda mlp, x, y, kw: tune_parallel(
        mlp, x, y, cost="adders", **kw),
    "tm-neuron": lambda mlp, x, y, kw: tune_time_multiplexed(
        mlp, x, y, scope="neuron", **kw),
    "tm-ann": lambda mlp, x, y, kw: tune_time_multiplexed(
        mlp, x, y, scope="ann", **kw),
}


@dataclass(frozen=True)
class DesignPoint:
    """One priced corner of the design space."""
    arch: str
    style: str
    q: int
    tuner: str            # key into TUNERS ("none" = untuned)
    ha: float             # hardware accuracy (%) on the evaluator's split
    area_um2: float
    latency_ns: float
    energy_pj: float
    cycles: int
    n_adders: int
    n_mults: int
    tnzd: int
    # serving-cost axis (DESIGN.md 14): matmul weight bytes at each layer's
    # effective bitwidth
    weight_bytes: float = 0.0

    def cost(self, metric: str):
        return getattr(self, metric)

    def row(self) -> str:
        return (f"{self.arch:11s} {self.style:10s} q={self.q} "
                f"{self.tuner:15s} ha={self.ha:5.1f}% "
                f"area={self.area_um2:9.0f} lat={self.latency_ns:9.1f}ns "
                f"E={self.energy_pj:10.0f}pJ adders={self.n_adders:4d} "
                f"tnzd={self.tnzd}")


@dataclass
class ExploreResult:
    points: list                      # every DesignPoint priced
    qs: list                          # the q ladder swept
    tuners: tuple                     # tuned/untuned variants swept
    stats: dict = field(default_factory=dict)

    def front(self, cost: str = "area_um2", acc: str = "ha") -> list:
        """Pareto front under (minimize ``cost``, maximize ``acc``)."""
        from .pareto import pareto_front
        return pareto_front(self.points,
                            cost=lambda p: p.cost(cost),
                            acc=lambda p: getattr(p, acc))

    def best(self, cost: str = "area_um2", min_ha: float = 0.0):
        """Cheapest point reaching ``min_ha``, or None."""
        ok = [p for p in self.points if p.ha >= min_ha]
        return min(ok, key=lambda p: p.cost(cost)) if ok else None


def explore(weights, biases, activations, x_val_int, y_val, *,
            qs=None, q_span: int = 2, arch_styles=ARCH_STYLES,
            tuners=("none", "parallel"), max_sweeps: int = 3,
            evaluator=None, planner=None, tech=TECH40,
            tune_kwargs=None, device="cuda") -> ExploreResult:
    """Sweep the design space of one float network and price every corner.

    ``qs`` is the quantization ladder; when omitted it is derived from the
    Section IV-A minimum-quantization search: ``[min_q .. min_q + q_span]``.
    ``tuners`` names variants from :data:`TUNERS`; each tuned variant runs
    once per q level (tuners run on the batched evaluation engine), then the
    whole ``(q, variant)`` grid is scored in stacked evaluator dispatches
    and priced across every ``(arch, style)`` combo on the cost IR.  The
    extra variant name ``"mixedbw"`` adds the greedy per-layer mixed-q
    network (:func:`repro_torch.quant.mixed_minq_search`, run once on the
    shared evaluator) as one more grid point; every point carries the
    serving-cost axis ``weight_bytes``, so ``result.front("weight_bytes")``
    is the quality-vs-serving-cost Pareto front.

    Pass ``evaluator`` (a :class:`~repro_torch.eval.QSweepEvaluator` on the
    same validation split) to share it with other sweeps, and ``planner``
    to share plan caches; both default to fresh / process-wide instances.
    ``device`` is where the default evaluator and the tuners' evaluators
    run (``tune_kwargs["device"]`` wins for the tuners).
    """
    t0 = time.time()
    shared_planner = planner is not None     # caller opted into cache sharing
    if planner is None:
        planner = default_planner
    unknown = [t for t in tuners if t not in TUNERS and t != "mixedbw"]
    if unknown:
        raise ValueError(f"unknown tuner variants {unknown}")
    if len(activations) != len(weights):
        # forward_int zips layers with activations, so a surplus entry would
        # silently drop the OUTPUT activation — make it an immediate error
        raise ValueError(f"{len(weights)} weight matrices need "
                         f"{len(weights)} activations, got "
                         f"{len(activations)}")
    if evaluator is None:
        from repro_torch.eval import QSweepEvaluator
        evaluator = QSweepEvaluator(x_val_int, y_val, device=device)
    pstats0 = dict(planner.stats)
    ev_calls0 = evaluator.stats["eval_calls"]
    # an explicit tune_kwargs["max_sweeps"] wins over the convenience param
    tune_kwargs = {"max_sweeps": max_sweeps, "device": device,
                   **(tune_kwargs or {})}

    if qs is None:
        qr = find_min_q(weights, biases, activations, x_val_int, y_val,
                        evaluator=evaluator)
        qs = list(range(qr.q, qr.q + q_span + 1))
    qs = sorted(int(q) for q in qs)

    # --- the (q, variant) network grid ------------------------------------
    base = {q: quantize_mlp(weights, biases, activations, q) for q in qs}
    grid: list[tuple[int, str, IntMLP]] = []
    tune_s = 0.0
    for name in tuners:
        if name == "mixedbw":
            # per-layer mixed bit widths: one greedy per-layer min-q search
            # on the shared evaluator (it picks its own rungs, so the q
            # ladder does not apply); its network embeds at the global q*
            # and scores in the same stacked dispatch as the rest
            from repro_torch.quant.mixed import mixed_minq_search
            t1 = time.time()
            mres = mixed_minq_search(weights, biases, activations,
                                     x_val_int, y_val, evaluator=evaluator,
                                     device=device)
            tune_s += time.time() - t1
            grid.append((mres.q_star, name, mres.mlp))
            continue
        tuner = TUNERS[name]
        kw = dict(tune_kwargs)
        if name == "parallel-adders" and shared_planner:
            # caller-owned planner: share plan caches with the cost axis
            # (by default the tuner keeps its run-local planner, so polish
            # candidates never accumulate in the process-wide cache)
            kw["planner"] = planner
        for q in qs:
            if tuner is None:
                grid.append((q, name, base[q]))
                continue
            t1 = time.time()
            res = tuner(base[q], x_val_int, y_val, kw)
            tune_s += time.time() - t1
            grid.append((q, name, res.mlp))

    # --- accuracy axis: stacked dispatches over the whole grid ------------
    has = evaluator.evaluate([mlp for (_q, _n, mlp) in grid])

    # --- cost axis: vectorized cost IR + warm planner ---------------------
    from repro_torch.quant.mixed import intmlp_serving_sheet
    points = []
    for (q, name, mlp), ha in zip(grid, has):
        t = csd.tnzd(list(mlp.weights) + list(mlp.biases))
        wb = intmlp_serving_sheet(mlp).weight_bytes()
        for arch, style in arch_styles:
            rep: DesignReport = design_cost(mlp, arch, style, tech=tech,
                                            planner=planner)
            points.append(DesignPoint(
                arch=arch, style=style, q=q, tuner=name, ha=ha,
                area_um2=rep.area_um2, latency_ns=rep.latency_ns,
                energy_pj=rep.energy_pj, cycles=rep.cycles,
                n_adders=rep.n_adders, n_mults=rep.n_mults, tnzd=t,
                weight_bytes=wb))

    return ExploreResult(
        points=points, qs=qs, tuners=tuple(tuners),
        stats={"n_points": len(points), "n_networks": len(grid),
               "eval_calls": evaluator.stats["eval_calls"] - ev_calls0,
               "planner_hits": planner.stats["hits"] - pstats0["hits"],
               "planner_misses": (planner.stats["misses"]
                                  - pstats0["misses"]),
               "tune_s": tune_s, "wall_s": time.time() - t0})
