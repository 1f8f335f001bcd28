"""Pareto-front extraction over (cost, accuracy) design points, a copy of
``repro/explore/pareto.py``.

The explorer's dominance convention (DESIGN.md 12.4): a point ``p`` is
dominated by ``q`` when ``q`` costs no more AND scores at least as well AND
differs on at least one axis.  The front is every non-dominated point, sorted
by cost ascending — accuracy is then strictly increasing along the front
(ties collapse to the cheapest representative).
"""
from __future__ import annotations

__all__ = ["dominates", "pareto_front", "is_pareto_front"]


def dominates(cost_a, acc_a, cost_b, acc_b) -> bool:
    """True when (cost_a, acc_a) dominates (cost_b, acc_b): cheaper-or-equal,
    at-least-as-accurate, and strictly better on one axis."""
    return (cost_a <= cost_b and acc_a >= acc_b
            and (cost_a < cost_b or acc_a > acc_b))


def pareto_front(points, *, cost, acc) -> list:
    """Non-dominated subset of ``points`` under ``(cost, acc)`` key
    functions (minimize cost, maximize accuracy), sorted by cost ascending.

    One sorted sweep: after ordering by ``(cost asc, acc desc)``, a point is
    on the front iff its accuracy strictly exceeds every cheaper point's —
    equal-(cost, acc) duplicates keep only the first (a canonical
    representative), so accuracy is strictly increasing along the result.
    """
    ordered = sorted(points, key=lambda p: (cost(p), -acc(p)))
    front: list = []
    best_acc = None
    for p in ordered:
        if best_acc is None or acc(p) > best_acc:
            front.append(p)
            best_acc = acc(p)
    return front


def is_pareto_front(front, points, *, cost, acc) -> bool:
    """Invariant check (used by tests and the explorer's own sanity pass):
    every front member is non-dominated in ``points``, and every non-front
    point is dominated by (or duplicates) a front member."""
    fs = set(map(id, front))
    for f in front:
        if any(dominates(cost(p), acc(p), cost(f), acc(f)) for p in points):
            return False
    for p in points:
        if id(p) in fs:
            continue
        if not any(dominates(cost(f), acc(f), cost(p), acc(p))
                   or (cost(f) == cost(p) and acc(f) == acc(p))
                   for f in front):
            return False
    return True
