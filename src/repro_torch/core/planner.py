"""Shared adder-graph planner, the memoized synthesis front-end (DESIGN.md
11.3): a numpy copy of ``repro/core/planner.py``.

One cache of finished :class:`~repro_torch.core.mcm.AdderGraph`s keyed by
canonicalized matrix content, ``(method, shape, int64-C-contiguous bytes)``,
so a matrix reappearing in any consumer (the tuners, ``archs.design_cost``,
``simurg.generate``), any call and any dtype hits the same plan.  Graphs
are returned by reference and must be treated as immutable; their
``depth`` / ``value_bounds`` memos accumulate on the shared instance.

The wrappers mirror the paper's Section V operation shapes: ``cavm_graphs``
(per-neuron shift-add, one (1, n) plan per column), ``cmvm_graph``
(per-layer shared shift-add, the (m, n) transpose plan) and ``mcm_graph``
(one variable times m constants, an (m, 1) plan).  ``cmvm_adders`` /
``cmvm_adder_cost`` price the shared plan, the cost surface that
``tune_parallel(cost="adders")`` climbs on (DESIGN.md 12.3).
"""
from __future__ import annotations

import numpy as np

from . import mcm

__all__ = ["SynthesisPlanner", "default_planner", "plan", "cavm_graphs",
           "cmvm_graph", "mcm_graph", "cavm_adder_cost", "cmvm_adder_cost"]


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

    # -- Section V operation shapes ---------------------------------------

    def cavm_graphs(self, w, method: str = "cse") -> list:
        """Per-output-column CAVM plans of a layer's (n_in, n_out) weights.

        The list itself is memoized on the whole-matrix content; a list hit
        counts one hit per column, so the stats ledger is the same as
        per-column serving.
        """
        w = np.ascontiguousarray(np.asarray(w, dtype=np.int64))
        key = ("cavm-list", method, w.shape, w.tobytes())
        graphs = self._cache.get(key)
        if graphs is None:
            graphs = [self.plan(w[:, m][None, :], method)
                      for m in range(w.shape[1])]
            self._cache[key] = graphs
        else:
            self.stats["hits"] += len(graphs)
        return list(graphs)

    def cmvm_graph(self, w, method: str = "cse") -> mcm.AdderGraph:
        """The layer-shared CMVM plan: realize ``w.T @ x`` as one block."""
        return self.plan(np.asarray(w, dtype=np.int64).T, method)

    def mcm_graph(self, constants, method: str = "cse") -> mcm.AdderGraph:
        """MCM plan: m constants times one variable, an (m, 1) matrix."""
        consts = np.asarray(constants, dtype=np.int64).ravel()
        if consts.size == 0:
            consts = np.asarray([1], dtype=np.int64)
        return self.plan(consts[:, None], method)

    # -- priced adder costs (DESIGN.md 12) ---------------------------------

    def column_graph(self, col, method: str = "cse") -> mcm.AdderGraph:
        """The CAVM plan of one weight column (a (1, n) dot product)."""
        return self.plan(np.asarray(col, dtype=np.int64).ravel()[None, :],
                         method)

    def column_adders(self, col, method: str = "cse") -> int:
        """Priced adder count of one column's shift-add plan."""
        return self.column_graph(col, method).n_adders

    def cavm_adder_cost(self, weights, method: str = "cse") -> int:
        """Priced CAVM adder cost of a network: the sum of every column
        plan's two-operand adder count (bias adders excluded).  A (1, n)
        column plan has a single output, so it degenerates to digit-based
        recoding: this equals ``tnzd(weights) - n_columns`` exactly."""
        return int(sum(g.n_adders for w in weights
                       for g in self.cavm_graphs(np.atleast_2d(
                           np.asarray(w, dtype=np.int64)), method)))

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


def plan(matrix, method: str = "cse") -> mcm.AdderGraph:
    return default_planner.plan(matrix, method)


def cavm_graphs(w, method: str = "cse") -> list:
    return default_planner.cavm_graphs(w, method)


def cmvm_graph(w, method: str = "cse") -> mcm.AdderGraph:
    return default_planner.cmvm_graph(w, method)


def mcm_graph(constants, method: str = "cse") -> mcm.AdderGraph:
    return default_planner.mcm_graph(constants, method)


def cavm_adder_cost(weights, method: str = "cse") -> int:
    return default_planner.cavm_adder_cost(weights, method)


def cmvm_adder_cost(weights, method: str = "cse") -> int:
    return default_planner.cmvm_adder_cost(weights, method)
