"""Batched hardware-accuracy evaluation engine (DESIGN.md 7, 10), the
counterpart of ``repro/eval``.

The paper's hardware-accuracy consumers are greedy searches that re-score the
integer network after every candidate move.  This package scores whole
batches of candidates in single integer forwards, bit-exact against the
numpy ``forward_int`` oracle in ``repro_torch.core.intmlp``, in two shapes:

* ``BatchedHWEvaluator`` (DESIGN.md 7): batches of single-column *mutations*
  of one committed network, with layer-prefix activation caching and the
  exact greedy batch shapes (independent / prefix / chain).  Drives the
  IV-B weight tuner.
* ``QSweepEvaluator`` (DESIGN.md 10): batches of whole networks sharing one
  structure, the multi-q sweep mode.  Drives the Section IV-A minimum-
  quantization search.

Both offer int32-safe device backends (``torch``, and ``csd`` through the
CUDA digit-plane kernels), demoting to int64 numpy past the int32 bounds.
"""
from .batched import (BatchedHWEvaluator, Candidate,  # noqa: F401
                      QSweepEvaluator, csd_net_int32_safe, ha_pct,
                      int32_safe_bound, net_int32_safe)

__all__ = ["BatchedHWEvaluator", "Candidate", "QSweepEvaluator", "ha_pct",
           "int32_safe_bound", "net_int32_safe", "csd_net_int32_safe"]
