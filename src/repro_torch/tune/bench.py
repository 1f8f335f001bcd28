"""Microbenchmark harness for the measured-dispatch races (DESIGN.md 17.1),
the counterpart of ``repro/tune/bench.py``.

``measure`` times one callable -- warmup runs first (kernel builds, device
transfers, cache warming all land there), then the median of k timed runs.
Median, not mean: one GC pause or scheduler hiccup must not crown the wrong
engine for the life of a cache entry.  Each timed run is finished work:
on the ``cuda`` platform the device is synchronised before the clock is
read at either end, so an asynchronous launch is never timed as its
enqueue.

``race`` times a dict of named :class:`Thunk`s and returns the winner.  The
card-only rule lives here: a thunk flagged ``cuda=True`` is a CUDA kernel,
which off the card runs as its plain PyTorch version, so its timing there
measures the plain version, not the kernel -- off the card those thunks
are excluded from the race (timing ``None``) rather than recorded as
honest losses.  A race whose thunks are ALL excluded returns no winner, so
the caller's static heuristic stands and nothing is cached.

The clock is injectable so the tests can drive deterministic races.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Mapping


@dataclass
class Thunk:
    """One race entrant: ``run`` performs a single timed invocation."""
    run: Callable[[], object]
    cuda: bool = False         # a CUDA kernel: off the card, its plain version


def _device_sync(platform: str) -> Callable[[], None] | None:
    if platform != "cuda":
        return None
    import torch
    return torch.cuda.synchronize


def measure(fn: Callable[[], object], *, warmup: int = 1, k: int = 5,
            clock: Callable[[], float] = time.perf_counter,
            sync: Callable[[], None] | None = None) -> float:
    """Median of ``k`` timed calls after ``warmup`` untimed ones.  ``sync``
    (``torch.cuda.synchronize`` on the card) runs before each clock read,
    so the time is that of finished work."""
    for _ in range(max(0, warmup)):
        fn()
    ts = []
    for _ in range(max(1, k)):
        if sync is not None:
            sync()
        t0 = clock()
        fn()
        if sync is not None:
            sync()
        ts.append(clock() - t0)
    ts.sort()
    n = len(ts)
    mid = n // 2
    return float(ts[mid] if n % 2 else (ts[mid - 1] + ts[mid]) / 2.0)


def race(thunks: Mapping[str, Thunk], *, platform: str,
         warmup: int = 1, k: int = 5,
         clock: Callable[[], float] = time.perf_counter
         ) -> tuple[str | None, dict[str, float | None]]:
    """Time every eligible thunk; return ``(winner, timings)``.

    ``timings[name]`` is the median seconds, or None when the thunk was
    excluded (a CUDA kernel off the card).  The winner is the fastest
    measured entrant, ties broken by name so the result is deterministic;
    None when nothing was eligible."""
    sync = _device_sync(platform)
    timings: dict[str, float | None] = {}
    for name, th in thunks.items():
        if th.cuda and platform != "cuda":
            timings[name] = None       # plain-version timing: not admissible
            continue
        timings[name] = measure(th.run, warmup=warmup, k=k, clock=clock,
                                sync=sync)
    measured = {n: t for n, t in timings.items() if t is not None}
    winner = (min(measured, key=lambda n: (measured[n], n))
              if measured else None)
    return winner, timings
