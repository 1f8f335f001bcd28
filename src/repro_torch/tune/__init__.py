"""Measured-dispatch autotuning (DESIGN.md 17), the counterpart of
``repro/tune``.

Realizations chosen by measured cost, not fixed heuristics, applied to the
port's own engine knobs.  Every ``auto`` selection point (the evaluators'
backends, the TM chain engine, the serving decode kernel) consults one
persistent cache of race winners via :func:`decide`; a miss falls back to the exact pre-autotuner static heuristic, and
measure-and-fill only runs when :func:`enabled` (the ``REPRO_TUNE`` env var
or a session override).

    from repro_torch import tune
    backend = tune.decide("qsweep_backend", shape=x.shape, dtype="int64",
                          candidates=("numpy", "torch"),
                          heuristic="numpy", plat="cpu",
                          measure=lambda: tune.qsweep_backend_thunks(x, y))

Candidates must already be proven bit-identical by the tests -- the cache
can only ever change wall-clock, never results.  The reference's
``csd_qsweep`` tile knob (``TILE_CANDIDATES``, ``TILE_HEURISTIC``,
``parse_tile``) has no counterpart: the port's ``csd_qsweep`` route is the
shape rule ``repro_torch.kernels.csd_matvec.route``.
"""
from .bench import Thunk, measure, race
from .cache import (SCHEMA_VERSION, DispatchCache, config_hash, make_key,
                    shape_bucket)
from .dispatch import (ENV_CACHE, ENV_ENABLED, decide, default_config,
                       enabled, get_cache, platform, set_cache, set_enabled,
                       stats, use_cache)
from .measurers import (bhw_backend_thunks, decode_kernel_thunks,
                        qsweep_backend_thunks, tm_chain_thunks)

__all__ = [
    "Thunk", "measure", "race",
    "SCHEMA_VERSION", "DispatchCache", "config_hash", "make_key",
    "shape_bucket",
    "ENV_CACHE", "ENV_ENABLED", "decide", "default_config", "enabled",
    "get_cache", "platform", "set_cache", "set_enabled", "stats",
    "use_cache",
    "qsweep_backend_thunks", "bhw_backend_thunks", "tm_chain_thunks",
    "decode_kernel_thunks",
]
