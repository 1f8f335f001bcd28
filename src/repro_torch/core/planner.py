"""Shared adder-graph planner, the memoized synthesis front-end (DESIGN.md
11.3): a numpy copy of what the port uses of ``repro/core/planner.py``.

One cache of finished :class:`~repro_torch.core.mcm.AdderGraph`s keyed by
canonicalized matrix content, ``(method, shape, int64-C-contiguous bytes)``,
so a matrix reappearing in any call and any dtype hits the same plan.
Graphs are returned by reference and must be treated as immutable.

``cmvm_adders`` / ``cmvm_adder_cost`` price the per-layer shared shift-add
plan (the (m, n) transpose of a layer's weights), the cost surface that
``tune_parallel(cost="adders")`` climbs on (DESIGN.md 12.3).
"""
from __future__ import annotations

import numpy as np

from . import mcm

__all__ = ["SynthesisPlanner", "default_planner"]


class SynthesisPlanner:
    """Memoized front-end over :func:`repro_torch.core.mcm.synthesize`."""

    def __init__(self):
        self._cache: dict = {}
        self.stats = {"hits": 0, "misses": 0}

    def plan(self, matrix, method: str = "cse") -> mcm.AdderGraph:
        """The (cached) shift-add plan for ``y = matrix @ x``."""
        matrix = np.ascontiguousarray(
            np.atleast_2d(np.asarray(matrix, dtype=np.int64)))
        key = (method, matrix.shape, matrix.tobytes())
        graph = self._cache.get(key)
        if graph is None:
            graph = mcm.synthesize(matrix, method)
            self._cache[key] = graph
            self.stats["misses"] += 1
        else:
            self.stats["hits"] += 1
        return graph

    def cmvm_graph(self, w, method: str = "cse") -> mcm.AdderGraph:
        """The layer-shared CMVM plan: realize ``w.T @ x`` as one block."""
        return self.plan(np.asarray(w, dtype=np.int64).T, method)

    def cmvm_adders(self, w, method: str = "cse") -> int:
        """Priced adder count of one layer's shared CMVM plan."""
        return self.cmvm_graph(np.atleast_2d(np.asarray(w, dtype=np.int64)),
                               method).n_adders

    def cmvm_adder_cost(self, weights, method: str = "cse") -> int:
        """Priced shared-plan adder cost of a network: the sum of per-layer
        CMVM plan adder counts.  Cross-output CSE sharing makes this a
        different surface from tnzd (dropping a CSD digit can break a shared
        subexpression and *raise* it)."""
        return int(sum(self.cmvm_adders(w, method) for w in weights))

    def clear(self) -> None:
        self._cache.clear()
        self.stats = {"hits": 0, "misses": 0}

    def __len__(self) -> int:
        return len(self._cache)


#: The process-wide planner every consumer shares by default.
default_planner = SynthesisPlanner()
