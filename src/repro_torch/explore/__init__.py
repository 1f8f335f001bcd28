"""Batched design-space explorer (DESIGN.md 12.4), the counterpart of
``repro/explore``.

Sweeps ``(arch x style) x q-ladder x tuned/untuned`` for one float network:
accuracy in stacked :class:`~repro_torch.eval.QSweepEvaluator` dispatches
(the ``csd_qsweep`` kernel on the card), cost on the vectorized cost IR +
warm shared planner, Pareto fronts out.  ``repro_torch.launch.explore`` is
its entry point.
"""
from .pareto import dominates, is_pareto_front, pareto_front  # noqa: F401
from .space import (DesignPoint, ExploreResult, TUNERS, explore)  # noqa: F401

__all__ = ["explore", "DesignPoint", "ExploreResult", "TUNERS",
           "pareto_front", "dominates", "is_pareto_front"]
