"""``decide`` -- the one entry point every ``auto`` knob consults
(DESIGN.md 17.3), the counterpart of ``repro/tune/dispatch.py``.

Resolution order for a knob's value:

1. **Cache hit** -- the session cache (or the file named by
   ``REPRO_TUNE_CACHE``) holds a winner for ``(platform, op, shape-bucket,
   dtype)`` and that winner is among the caller's candidates -> use it.
2. **Measure-and-fill** -- on a miss, when tuning is enabled
   (:func:`enabled`) and the caller supplied a thunk factory, race the
   candidates (:func:`repro_torch.tune.bench.race`), record the winner,
   autosave when a cache file is configured.  The factory is only invoked
   here, so call sites pay nothing for it on the hit/disabled paths.
3. **Heuristic** -- otherwise return the caller's static heuristic: exactly
   the pre-autotuner behavior.  This is the correctness backstop -- decide()
   can only ever pick among candidates the caller declares, and callers
   only declare implementations their tests already prove bit-identical
   (the DESIGN.md 17.4 contract), so no cache state can change results.

The platform is ``"cuda"`` or ``"cpu"``, and each call site passes its own
device's (``plat=device.type``), so an evaluator built on the CPU of a
machine with a card neither reads nor writes the card's winners.  The
cache file's config stamp names the platform, the torch and CUDA versions
and the card, so a file written by the JAX package or on another card
loads stale and empty.

Module state is deliberately tiny: an enabled override (else the
``REPRO_TUNE`` env var) and one process-wide cache (else built from
``REPRO_TUNE_CACHE``).  ``use_cache`` scopes both for tests and for
forced-pick parity checks.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Callable, Mapping, Sequence

from .bench import Thunk, race
from .cache import DispatchCache, make_key, shape_bucket

ENV_ENABLED = "REPRO_TUNE"
ENV_CACHE = "REPRO_TUNE_CACHE"

_state: dict = {"enabled": None, "cache": None}
stats = {"hits": 0, "misses": 0, "fills": 0, "heuristic": 0}


def platform() -> str:
    """The process's dispatch platform: ``"cuda"`` when a card is visible,
    else ``"cpu"``."""
    p = _state.get("platform")
    if p is None:
        import torch
        p = "cuda" if torch.cuda.is_available() else "cpu"
        _state["platform"] = p
    return p


def default_config() -> dict:
    """The environment fields that make timings comparable -- the cache
    file's config-hash basis."""
    import torch
    plat = platform()
    return {"platform": plat, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(0) if plat == "cuda"
                       else None)}


def enabled() -> bool:
    """Is measure-and-fill on?  Session override first, else REPRO_TUNE."""
    if _state["enabled"] is not None:
        return bool(_state["enabled"])
    return os.environ.get(ENV_ENABLED, "").strip().lower() in (
        "1", "true", "on", "yes", "measure")


def set_enabled(flag: bool | None) -> None:
    """Session override for :func:`enabled` (None = back to the env var)."""
    _state["enabled"] = flag


def get_cache() -> DispatchCache:
    """The process-wide cache; first use loads ``REPRO_TUNE_CACHE`` if set
    (stale stamps self-invalidate to empty -- see cache.py)."""
    if _state["cache"] is None:
        path = os.environ.get(ENV_CACHE)
        cfg = default_config()
        _state["cache"] = (DispatchCache.load(path, config=cfg) if path
                           else DispatchCache(cfg))
    return _state["cache"]


def set_cache(cache: DispatchCache | None) -> None:
    _state["cache"] = cache


@contextmanager
def use_cache(cache: DispatchCache | None, *, measure: bool | None = False):
    """Scope the process cache (and optionally the enabled flag) -- the
    tests' forced-pick mechanism."""
    prev_cache, prev_enabled = _state["cache"], _state["enabled"]
    _state["cache"] = cache
    _state["enabled"] = measure
    try:
        yield cache
    finally:
        _state["cache"], _state["enabled"] = prev_cache, prev_enabled


def _autosave(cache: DispatchCache) -> None:
    path = os.environ.get(ENV_CACHE)
    if path and cache is _state["cache"]:
        try:
            cache.save(path)
        except OSError:
            pass                       # persistence is best-effort


def decide(op: str, *, shape: Sequence[int], candidates: Sequence[str],
           heuristic: str | Callable[[], str], dtype: str = "",
           measure: Callable[[], Mapping[str, Thunk]] | None = None,
           cache: DispatchCache | None = None, plat: str | None = None,
           warmup: int = 1, k: int = 3) -> str:
    """Pick one of ``candidates`` for ``op`` at ``shape``/``dtype``.

    Cache winner if present and still a declared candidate; else a measured
    race when enabled and ``measure`` (a zero-arg factory returning
    ``{name: Thunk}``) is given; else ``heuristic`` (a value or a zero-arg
    callable -- today's static rule, bit-identical fallback)."""
    cache = cache if cache is not None else get_cache()
    plat = plat if plat is not None else platform()
    key = make_key(plat, op, shape_bucket(shape), dtype)
    rec = cache.get(key)
    if rec is not None and rec.get("winner") in candidates:
        stats["hits"] += 1
        return rec["winner"]
    stats["misses"] += 1
    if measure is not None and enabled():
        winner, timings = race(dict(measure()), platform=plat,
                               warmup=warmup, k=k)
        if winner is not None:
            cache.put(key, winner, timings=timings,
                      candidates=list(candidates))
            stats["fills"] += 1
            _autosave(cache)
            return winner
    stats["heuristic"] += 1
    return heuristic() if callable(heuristic) else heuristic
