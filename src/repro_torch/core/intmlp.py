"""Bit-exact integer MLP semantics, the "hardware accuracy" oracle
(counterpart of ``repro/core/intmlp.py``).

The paper evaluates every tuning candidate by the ANN's *hardware* accuracy:
the network computed with integer weights/biases, 8-bit activations, and the
hardware activation functions (hsig / htanh / satlin / relu / lin).

Fixed-point scheme
------------------
* Activations: signed 8-bit, FRAC = 7 fractional bits, value a = a_int / 2^7,
  representable range [-1, 1).  Paper Section VII fixes layer IO bitwidth at 8.
* Weights/biases: integers at scale 2^q (paper Section IV-A: ceil(w * 2^q)).
* Accumulator: y_int = sum_i w_int a_int + (b_int << FRAC), at scale 2^(q+7).
* Activation applied on the accumulator (exact shift/clamp arithmetic), then
  re-quantized to 8 bits by an arithmetic right shift of q.

All arithmetic is int64 (numpy) / int32 (torch), exact, with no rounding
besides the specified shifts, so the numpy and torch paths agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FRAC = 7  # fractional bits of the 8-bit activation representation
ACT_MIN, ACT_MAX = -(1 << FRAC), (1 << FRAC) - 1

HW_ACTIVATIONS = ("htanh", "hsig", "satlin", "relu", "lin")


@dataclass
class IntMLP:
    """Integer-weight MLP: weights[k] has shape (n_in_k, n_out_k)."""

    weights: list  # list[np.ndarray int64 (n_in, n_out)]
    biases: list   # list[np.ndarray int64 (n_out,)]
    activations: list  # list[str], one per layer
    q: int         # weight scale exponent

    def copy(self) -> "IntMLP":
        return IntMLP([w.copy() for w in self.weights],
                      [b.copy() for b in self.biases],
                      list(self.activations), self.q)

    @property
    def structure(self) -> list:
        return [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]


def _clip(acc, lo, hi):
    """``clip`` for numpy arrays and torch tensors, bounds scalar or
    broadcastable arrays of the accumulator's dtype."""
    if not isinstance(acc, torch.Tensor):
        return np.clip(acc, lo, hi)
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.minimum(torch.maximum(acc, torch.as_tensor(lo).to(acc)),
                             torch.as_tensor(hi).to(acc))
    return torch.clamp(acc, lo, hi)


def act_requant(acc, act: str, q):
    """Hardware activation + 8-bit requantization on an accumulator at scale
    2^(q+FRAC): the single source of the activation contract.

    * ``htanh``/``satlin`` clamp to the representable band; ``relu`` clamps to
      [0, 1) too so the 8-bit requantization cannot wrap (documented
      deviation, DESIGN 8); ``hsig(y) = clamp(y/2 + 1/2, 0, 1)`` is exact
      shift-then-offset arithmetic.
    * Works on numpy arrays (any integer dtype; the clamp constant follows
      the accumulator dtype, so int32 stays int32) and on torch integer
      tensors, where ``>>`` is arithmetic on negatives as in numpy.
    * ``q`` may also be an integer *array* or tensor broadcastable against
      ``acc`` (shape ``(Q, 1, 1)`` in the multi-q sweep mode, DESIGN.md 10):
      every stacked network then requantizes with its own shift.
    """
    is_torch = isinstance(acc, torch.Tensor)
    if isinstance(q, (int, np.integer)):
        shift = int(q)
        one = 1 << (shift + FRAC) if is_torch else acc.dtype.type(
            1 << (shift + FRAC))
    elif is_torch:      # per-network q levels of a stacked sweep batch
        shift = torch.as_tensor(q, device=acc.device).to(acc.dtype)
        one = torch.ones((), dtype=acc.dtype, device=acc.device) \
            << (shift + FRAC)
    else:
        shift = np.asarray(q).astype(acc.dtype)
        one = np.asarray(1, dtype=acc.dtype) << (shift + FRAC)
    if act == "htanh":
        acc = _clip(acc, -one, one)
    elif act in ("satlin", "relu"):
        acc = _clip(acc, 0, one)
    elif act == "hsig":
        acc = _clip((acc >> 1) + (one >> 1), 0, one)
    elif act != "lin":
        raise ValueError(f"unknown hardware activation {act!r}")
    return _clip(acc >> shift, ACT_MIN, ACT_MAX)


def forward_int(mlp: IntMLP, x_int: np.ndarray, return_acc: bool = False) -> np.ndarray:
    """Bit-exact integer forward pass (int64 numpy, the oracle).

    x_int: (batch, n_in) int64 activations at scale 2^FRAC.
    Returns 8-bit output activations (batch, n_out); if return_acc, returns the
    final-layer pre-activation accumulators instead.
    """
    a = x_int.astype(np.int64)
    last_acc = None
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        acc = a @ w.astype(np.int64) + (b.astype(np.int64) << FRAC)
        last_acc = acc
        a = act_requant(acc, act, mlp.q)
    return last_acc if return_acc else a


def hardware_accuracy(mlp: IntMLP, x_int: np.ndarray, labels: np.ndarray) -> float:
    """Classification accuracy (%) of the integer network: the paper's ha."""
    out = forward_int(mlp, x_int)
    pred = np.argmax(out, axis=1)
    return 100.0 * float(np.mean(pred == labels))


def quantize_inputs(x_float: np.ndarray) -> np.ndarray:
    """Quantize float inputs in [-1, 1) to the 8-bit activation grid."""
    return np.clip(np.round(x_float * (1 << FRAC)), ACT_MIN, ACT_MAX).astype(np.int64)


def matmul_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer (batched) matrix product in ``a``'s integer dtype.

    PyTorch has no integer matmul on CUDA, so there the product runs in
    float64 and is cast back: every product and partial sum is an integer,
    exact below 2^53, which the int32 guards of ``repro_torch.eval`` keep
    every accumulator below (2^31).  On the CPU the integer matmul runs
    as is."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(a.dtype)
    return torch.matmul(a, b)


def forward_int_torch(mlp: IntMLP, x_int, device="cuda") -> torch.Tensor:
    """int32 torch twin of :func:`forward_int` (of ``forward_int_jax`` in
    the reference): returns the 8-bit output activations on ``device``."""
    a = torch.as_tensor(np.asarray(x_int), device=device).to(torch.int32)
    for w, b, act in zip(mlp.weights, mlp.biases, mlp.activations):
        w_t = torch.as_tensor(np.asarray(w, np.int32), device=device)
        b_t = torch.as_tensor(np.asarray(b, np.int32), device=device)
        a = act_requant(matmul_int(a, w_t) + (b_t << FRAC), act, mlp.q)
    return a
