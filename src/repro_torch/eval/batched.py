"""Batched bit-exact hardware-accuracy evaluator (DESIGN.md 7), the
counterpart of ``repro/eval/batched.py``.

Core idea: a tuning candidate mutates ONE column of ONE layer (a single
weight w[row, col], optionally together with the same column's bias).  With
the committed network's per-layer activations and accumulators cached, the
candidate's forward pass collapses to

* layer k     : a column update   acc[:, col] += a[:, row] * dw + (db << 7)
* layer k + 1 : a rank-1 update   acc' = acc + outer(dcol, W[k+1][col])
* layers k+2+ : dense batched matmuls over the (K * M, n) flattened batch

and the final argmax-vs-label comparison is computed without an argmax via a
unique integer score ``a * n + (n - 1 - j)`` whose row maximum identifies
numpy's first-index argmax exactly (ties included).  All arithmetic matches
``repro_torch.core.intmlp.forward_int`` bit for bit; accuracies are returned
through the same ``100.0 * (count / M)`` float64 expression the numpy oracle
uses, so greedy ``>=`` threshold decisions are reproduced exactly.

Backends (the reference's names in brackets)
--------------------------------------------
* ``numpy`` [``numpy``] - int64 on the host, always exact.
* ``torch`` [``jnp``]   - int32 tensors on ``device``, used while the int32
  worst-case accumulator bound holds, else demoted to numpy.  PyTorch has
  no integer matmul on CUDA, so there the products run in float64, exact
  because the same guards keep every partial sum below 2^31 < 2^53.
* ``csd``   [``pallas``] - ``torch`` with the dense matmuls routed through
  the digit-plane shift-add kernels (``csd_matvec`` for the mutation
  engine's tail, ``csd_qsweep`` for the sweep engine): the bit-exact
  hardware datapath, CUDA kernels on the card and their plain versions on
  the CPU.

``auto`` resolves to ``csd`` on a CUDA device for both evaluators: the hand
kernels are the card's exact integer product.  On the CPU it follows the
reference: ``numpy`` for the sweep engine and ``torch`` for the mutation
engine.  All backends give bit-identical results, so the pick moves only
wall time.  Sharding the validation rows (the reference's ``shard=True``)
is not ported.

Two evaluators live here:

* :class:`BatchedHWEvaluator`: the tuners' stateful engine, ONE committed
  network and batches of single-column *mutations* of it (DESIGN.md 7).
  Its chains (:meth:`~BatchedHWEvaluator.evaluate_chain`) run on the host,
  as the reference's do on every backend but a TPU.
* :class:`QSweepEvaluator`: the sweep engine, batches of *whole networks*
  sharing one (structure, activations), e.g. the same float weights
  quantized at several candidate q levels, scored in one stacked integer
  forward (the multi-q sweep mode, DESIGN.md 10).  The Section IV-A min-q
  search drives its sweeps through it.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.intmlp import ACT_MAX, FRAC, IntMLP, act_requant

__all__ = ["Candidate", "BatchedHWEvaluator", "QSweepEvaluator", "ha_pct",
           "int32_safe_bound", "net_int32_safe", "csd_net_accum_bound",
           "csd_net_int32_safe"]

_NEG = -(1 << 30)      # impossible score: a row that can never be correct
_SPEC_CHUNK = 32       # prefix-composition (speculative) chunk size


def ha_pct(count: int, n_val: int) -> float:
    """The oracle's accuracy expression: ``100.0 * mean(pred == labels)``.

    ``count / n_val`` in float64 is exactly ``np.mean`` of the boolean hit
    vector, so greedy comparisons against serial-tuner thresholds agree.
    """
    return 100.0 * (count / n_val)


@dataclass(frozen=True)
class Candidate:
    """One mutation of an IntMLP: weight [row, col] of ``layer`` set to
    ``wnew`` (when ``row >= 0``) and/or the same column's bias shifted by
    ``dbias``.  Weight and bias mutations share ``col`` so the whole candidate
    stays a single-column update (all the tuners need)."""

    layer: int
    col: int
    row: int = -1
    wnew: int = 0
    dbias: int = 0


def int32_safe_bound(mlp: IntMLP, slack_mult: int = 4,
                     bias_slack: int = 16) -> bool:
    """True when every layer's worst-case |accumulator| — including a mutated
    weight up to ``slack_mult * max|W|`` and a bias nudged by ``bias_slack`` —
    stays below 2^31, so the int32 torch path is bit-exact (DESIGN.md 7.3)."""
    amax = 1 << FRAC
    for w, b in zip(mlp.weights, mlp.biases):
        w = np.abs(np.asarray(w, dtype=np.int64))
        col_sum = int(w.sum(axis=0).max()) if w.size else 0
        wmax = int(w.max()) if w.size else 0
        bmax = int(np.abs(np.asarray(b, dtype=np.int64)).max()) if b.size else 0
        bound = (col_sum + slack_mult * max(wmax, 1)) * amax \
            + ((bmax + bias_slack) << FRAC)
        if bound >= 2 ** 31:
            return False
    return True


def _layer_accum_bound(w, b) -> int:
    """Worst-case |accumulator| of one layer *as is* (no mutation slack):
    ``sum_col |W| * amax + |b| << FRAC``.  Every partial sum of the layer
    matmul is bounded by it (a sum of absolute values), so it also bounds
    the intermediates of reordered/blocked summation."""
    amax = 1 << FRAC
    w = np.abs(np.asarray(w, dtype=np.int64))
    col_sum = int(w.sum(axis=0).max()) if w.size else 0
    bmax = int(np.abs(np.asarray(b, dtype=np.int64)).max()) if b.size else 0
    return col_sum * amax + (bmax << FRAC)


def net_accum_bound(mlp: IntMLP) -> int:
    """Mutation-free worst-case |accumulator| of the network: the max of
    ``_layer_accum_bound`` over layers — the quantity every sweep-mode
    exactness guard compares (DESIGN.md 10)."""
    return max(_layer_accum_bound(w, b)
               for w, b in zip(mlp.weights, mlp.biases))


def net_int32_safe(mlp: IntMLP) -> bool:
    """Per-q-level demotion bound of the sweep mode (DESIGN.md 10): sweep
    batches carry no candidate mutations, so no slack terms apply — networks
    past the int32 bound are scored on the host path while the rest of the
    batch stays on device."""
    return net_accum_bound(mlp) < 2 ** 31


def csd_net_accum_bound(mlp: IntMLP) -> int:
    """Worst-case |accumulator| of the network on the *digit-plane* datapath
    (DESIGN.md 11.4).  The shift-add kernels accumulate ``x @ p_d << d``
    plane by plane, so the intermediates are bounded by the CSD
    absolute-digit reconstruction ``sum_i |d_i| 2^i`` of each weight —
    up to ~4/3 of |w| (e.g. |7| -> 1 + 8 = 9) — not by |w| itself; the
    csd sweep backend demotes per network on this tighter bound."""
    from repro_torch.core.csd import from_csd_array, to_csd_array
    amax = 1 << FRAC
    worst = 0
    for w, b in zip(mlp.weights, mlp.biases):
        w = np.asarray(w, dtype=np.int64)
        if w.size:
            wabs = from_csd_array(np.abs(to_csd_array(w)))
            col_sum = int(wabs.sum(axis=0).max())
        else:
            col_sum = 0
        bmax = int(np.abs(np.asarray(b, dtype=np.int64)).max()) if b.size else 0
        worst = max(worst, col_sum * amax + (bmax << FRAC))
    return worst


def csd_net_int32_safe(mlp: IntMLP) -> bool:
    """Per-network demotion bound of the csd (digit-plane) sweep backend."""
    return csd_net_accum_bound(mlp) < 2 ** 31


# float integer-exactness limits: every product and (blocked/FMA) partial
# sum of the BLAS sweep path is an integer below the mantissa capacity,
# hence exact.  The f32 tier additionally needs q + FRAC < 24 so the hsig
# offset 2^(q+FRAC-1) stays representable next to the accumulator.
_F64_EXACT = 1 << 53
_F32_EXACT = 1 << 24


def _float_requant_inplace(acc: np.ndarray, act: str, inv) -> None:
    """Float twin of ``act_requant`` for integer-valued accumulators within
    the dtype's exact-integer range (the BLAS sweep path, DESIGN.md 10) —
    in place on float32/float64 ``acc``; ``inv`` is the exact scale ``2^-q``
    (a scalar, or ``(Q, 1, 1)`` for a per-network stacked batch).

    Arithmetic shifts become multiply-by-``2^-q`` + ``floor`` (floor equals
    the arithmetic shift for negatives, and a power-of-two multiply only
    moves the exponent, so both are exact); the pre-clamp at ``±2^(q+FRAC)``
    folds into the final 8-bit clip because its bounds are integer multiples
    of ``2^q`` — which also makes ``htanh`` and ``lin`` coincide here, as
    they do after the int shift+clip.  ``hsig`` keeps its extra
    ``floor(acc/2)`` half-step, then lands at offset ``+64`` on the common
    scale.  The clip bounds stay *scalars* on the common scale, so the whole
    requant is a handful of vectorized passes even for mixed-q stacks.
    Every intermediate is exactly representable, so results match
    ``act_requant`` bit for bit (asserted by the sweep parity tests).
    """
    dt = acc.dtype.type
    if act == "hsig":
        acc *= dt(0.5)
        np.floor(acc, out=acc)
        acc *= inv
        acc += dt(1 << (FRAC - 1))
        lo = dt(0.0)
    elif act in ("satlin", "relu"):
        acc *= inv
        lo = dt(0.0)
    elif act in ("htanh", "lin"):
        acc *= inv
        lo = dt(-(1 << FRAC))
    else:
        raise ValueError(f"unknown hardware activation {act!r}")
    np.floor(acc, out=acc)
    np.clip(acc, lo, dt(ACT_MAX), out=acc)


# the single activation-contract helper from the oracle module
_act_requant_np = act_requant


def _stacked_score_counts(a: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Correct counts from stacked final activations (B, Mp, n_out): the
    unique-score argmax trick of DESIGN.md 7.2, batch over axis 0.  Rows
    labelled -1 never score correct."""
    n_out = a.shape[2]
    score = a * n_out + (n_out - 1 - np.arange(n_out, dtype=np.int64))
    smax = score.max(axis=2)
    lab_safe = np.maximum(labels, 0)
    slab = np.take_along_axis(
        score, np.broadcast_to(lab_safe[None, :, None],
                               score.shape[:2] + (1,)), axis=2)[..., 0]
    slab = np.where(labels[None, :] < 0, _NEG, slab)
    return np.sum(slab == smax, axis=1)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that is not visible
    raises (the evaluators never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device "
                           "is visible; pass device='cpu' to run on the CPU")
    return dev


class BatchedHWEvaluator:
    """Stateful batched evaluator: owns the committed IntMLP, its layer-prefix
    caches (host, int64) and, on the ``torch``/``csd`` backends, their int32
    mirrors on ``device`` (``torchtail.TorchState``).

    Usage (the tuners' contract)::

        ev = BatchedHWEvaluator(mlp, x_val_int, y_val, device="cuda")
        bha = ev.accuracy()
        has = ev.evaluate([Candidate(...), ...])   # all in one layer
        ev.commit(candidate)                       # mutates + refreshes caches
    """

    def __init__(self, mlp: IntMLP, x_val_int: np.ndarray,
                 labels: np.ndarray, *, backend: str = "auto",
                 chunk: int = 128, shard: bool = False, device="cuda"):
        if backend not in ("auto", "numpy", "torch", "csd"):
            raise ValueError(backend)
        if shard:
            raise NotImplementedError("sharding the validation rows is not "
                                      "ported")
        self.device = resolve_device(device)
        self._mlp = mlp.copy()
        self.n_val = int(x_val_int.shape[0])
        self.chunk = int(chunk)
        self.stats = {"eval_calls": 0, "candidates": 0, "commits": 0,
                      "refreshes": 0}
        self._x = np.asarray(x_val_int, dtype=np.int64)
        self._labels = np.asarray(labels, dtype=np.int64)
        self._mp = self.n_val
        self._resolve_backend(backend)
        self._dev = None
        self._refresh(0)

    # -- public API --------------------------------------------------------

    @property
    def mlp(self) -> IntMLP:
        """The committed network (read for candidate generation; mutate only
        through :meth:`commit`)."""
        return self._mlp

    def accuracy(self) -> float:
        """Hardware accuracy (%) of the committed network, from the cache."""
        return ha_pct(self._count, self.n_val)

    def evaluate(self, cands: Sequence[Candidate]) -> list[float]:
        """Hardware accuracy (%) of each candidate, committed state untouched.

        All candidates must target the same layer (the tuners' sweep order
        guarantees this); batches larger than ``chunk`` are split internally.
        """
        if not cands:
            return []
        k = cands[0].layer
        if any(c.layer != k for c in cands):
            raise ValueError("candidates must share a layer")
        out: list[float] = []
        for lo in range(0, len(cands), self.chunk):
            out.extend(self._eval_chunk(k, cands[lo:lo + self.chunk]))
        self.stats["eval_calls"] += (len(cands) + self.chunk - 1) // self.chunk
        self.stats["candidates"] += len(cands)
        return out

    @property
    def spec_chunk(self) -> int:
        """Max candidates per :meth:`evaluate_prefix` call."""
        return _SPEC_CHUNK

    def evaluate_prefix(self, cands: Sequence[Candidate]) -> list[float]:
        """Hardware accuracy (%) of *prefix-composed* networks: entry ``c`` is
        the committed network with candidates ``0..c`` ALL applied.

        This is the speculative mode for commit-heavy greedy phases: while
        every prefix keeps clearing the greedy threshold, the serial tuner
        would have accepted each candidate in turn, so one call scores a whole
        run of commits (DESIGN.md 7.5).  Candidates must share a layer and
        target distinct weights; at most ``spec_chunk`` per call (prefixes
        cannot span calls).  Committed state is untouched.
        """
        if not cands:
            return []
        if len(cands) > _SPEC_CHUNK:
            raise ValueError(f"at most {_SPEC_CHUNK} prefix candidates")
        k = self._composed_layer(cands)
        n, wi, wj, dw, db = self._pack(cands)
        if self.backend == "numpy" or not self._spec_safe(k, dw, db):
            counts = self._prefix_np(k, wi, wj, dw, db)
        else:
            counts = self._device_counts(k, wi, wj, dw, db, kind="spec")
        self.stats["eval_calls"] += 1
        self.stats["candidates"] += n
        return [ha_pct(int(c), self.n_val) for c in counts[:n]]

    def evaluate_chain(self, cands: Sequence[Candidate],
                       bha: float) -> tuple[list[bool], list[float]]:
        """Follow the serial greedy chain through ``cands`` in one call on
        the host (the reference's chain off a TPU): candidate ``c`` is
        scored against the network with every *previously accepted*
        candidate applied, accepted iff its accuracy
        clears the running best (``>=``, updating it), exactly like the serial
        hill-climb (DESIGN.md 7.5).  Returns (accept_flags, accuracies);
        committed state is untouched — commit the accepted candidates with
        :meth:`commit_many`.

        ``bha`` must be the running best accuracy, which in a greedy sweep is
        always the committed network's own accuracy.  Accept decisions then
        reduce to exact integer correct-count comparisons because
        ``count -> 100.0 * (count / M)`` is strictly increasing.
        """
        if not cands:
            return [], []
        if len(cands) > self.chunk:
            raise ValueError(f"at most {self.chunk} chain candidates")
        k = self._composed_layer(cands)
        if ha_pct(self._count, self.n_val) != bha:
            raise ValueError("bha must equal the committed network's "
                             "accuracy (greedy invariant)")
        n, wi, wj, dw, db = self._pack(cands)
        counts, flags = self._chain_np(k, wi, wj, dw, db)
        self.stats["eval_calls"] += 1
        self.stats["candidates"] += n
        return ([bool(f) for f in flags[:n]],
                [ha_pct(int(c), self.n_val) for c in counts[:n]])

    def _chain_np(self, k: int, wi, wj, dw, db):
        """int64 numpy chain over the cached prefix state.

        Exploits decision sparsity: a single-weight mutation usually leaves
        the requantized layer-k output column unchanged for most validation
        rows, so each step recomputes the network tail only for the rows
        whose column value actually moved, against a maintained per-row
        correctness bitmap (DESIGN.md 7.5).
        """
        mlp = self._mlp
        q = mlp.q
        n_layers = len(mlp.weights)
        last = k == n_layers - 1
        act_k = mlp.activations[k]
        # int32 halves the loop's memory traffic; exact under the same
        # worst-case accumulator guard as the device paths.
        dt = np.int32 if self._spec_safe(k, dw, db) else np.int64
        a_k = self._a[k].astype(dt)
        acc_k = self._acc[k].astype(dt)
        a_k1 = self._a[k + 1].astype(dt)
        acc_n = None if last else self._acc[k + 1].astype(dt)
        w_next = None if last else mlp.weights[k + 1].astype(dt)
        w_deep = [mlp.weights[l].astype(dt)
                  for l in range(k + 2, n_layers)]
        bsh_deep = [(mlp.biases[l].astype(np.int64) << FRAC).astype(dt)
                    for l in range(k + 2, n_layers)]
        correct = self._slab == self._score.max(axis=1)           # (Mp,)
        cnt = self._count
        n_out = self._a[-1].shape[1]
        pen = n_out - 1 - np.arange(n_out, dtype=dt)
        lab_safe = np.maximum(self._labels, 0)
        real = self._labels >= 0
        ar = np.arange(self._mp)
        buf = np.empty(self._mp, dt)
        counts = np.empty(len(wi), np.int64)
        flags = np.empty(len(wi), bool)
        for t in range(len(wi)):
            j = wj[t]
            np.multiply(a_k[:, wi[t]], dw[t], out=buf)
            buf += acc_k[:, j]
            if db[t]:
                buf += db[t]
            h_new = _act_requant_np(buf, act_k, q)
            dcol = h_new - a_k1[:, j]
            idx = np.nonzero(dcol)[0]
            if len(idx) == 0:
                cnt_c = cnt
                corr_rows = acc_rows = None
            else:
                if last:
                    rows = a_k1[idx]
                    rows[:, j] = h_new[idx]
                    acc_rows = None
                else:
                    acc_rows = acc_n[idx] + dcol[idx, None] * w_next[j][None]
                    rows = _act_requant_np(acc_rows,
                                           mlp.activations[k + 1], q)
                    for li, l in enumerate(range(k + 2, n_layers)):
                        rows = _act_requant_np(
                            rows @ w_deep[li] + bsh_deep[li],
                            mlp.activations[l], q)
                score = rows * n_out
                score += pen
                slab = score[ar[:len(idx)], lab_safe[idx]]
                corr_rows = (slab == score.max(axis=1)) & real[idx]
                cnt_c = cnt - int(correct[idx].sum()) + int(corr_rows.sum())
            ok = cnt_c >= cnt
            if ok:
                cnt = cnt_c
                acc_k[:, j] = buf
                a_k1[:, j] = h_new
                if len(idx):
                    if not last:
                        acc_n[idx] = acc_rows
                    correct[idx] = corr_rows
            counts[t] = cnt_c
            flags[t] = ok
        return counts, flags

    def commit_many(self, cands: Sequence[Candidate]) -> None:
        """Commit a run of same-layer candidates (an accepted prefix from
        :meth:`evaluate_prefix`) with one cache refresh for the whole run."""
        if not cands:
            return
        k = cands[0].layer
        for c in cands:
            if c.layer != k:
                raise ValueError("candidates must share a layer")
            if c.row >= 0:
                self._mlp.weights[k][c.row, c.col] = c.wnew
            if c.dbias:
                self._mlp.biases[k][c.col] += c.dbias
        self._refresh(k)
        self.stats["commits"] += len(cands)
        if self.backend != "numpy" and not int32_safe_bound(self._mlp):
            self._demote("commit pushed accumulators past int32 range")

    def commit(self, c: Candidate) -> None:
        """Apply one candidate to the committed network and refresh the
        layer-prefix caches incrementally (column + rank-1 updates; dense
        recompute only for layers >= c.layer + 2)."""
        k, j = c.layer, c.col
        w_k = self._mlp.weights[k]
        dw = 0
        if c.row >= 0:
            dw = int(c.wnew) - int(w_k[c.row, j])
            w_k[c.row, j] = c.wnew
        if c.dbias:
            self._mlp.biases[k][j] += c.dbias

        acc_col = self._acc[k][:, j]
        if dw:
            acc_col += self._a[k][:, c.row] * np.int64(dw)
        if c.dbias:
            acc_col += np.int64(c.dbias) << FRAC
        new_col = _act_requant_np(acc_col, self._mlp.activations[k],
                                  self._mlp.q)
        n_layers = len(self._mlp.weights)
        changed = {"layer": k, "a": set(), "acc": {k}, "scores": False}
        dcol = new_col - self._a[k + 1][:, j]
        if np.any(dcol):
            self._a[k + 1][:, j] = new_col
            changed["a"].add(k + 1)
            changed["scores"] = True
            if k < n_layers - 1:
                self._acc[k + 1] += np.outer(dcol,
                                             self._mlp.weights[k + 1][j])
                changed["acc"].add(k + 1)
                for l in range(k + 1, n_layers):
                    self._a[l + 1] = _act_requant_np(
                        self._acc[l], self._mlp.activations[l], self._mlp.q)
                    changed["a"].add(l + 1)
                    if l + 1 < n_layers:
                        self._acc[l + 1] = (
                            self._a[l + 1] @ self._mlp.weights[l + 1]
                            + (self._mlp.biases[l + 1].astype(np.int64)
                               << FRAC))
                        changed["acc"].add(l + 1)
            self._refresh_scores()
        self.stats["commits"] += 1

        if self.backend != "numpy":
            if not int32_safe_bound(self._mlp):
                self._demote("commit pushed accumulators past int32 range")
            else:
                self._sync_device(changed)

    # -- backend selection -------------------------------------------------

    def _resolve_backend(self, backend: str) -> None:
        if backend == "auto":
            # the static rule: the digit-plane kernels are the card's exact
            # integer product; on the CPU the reference's int32 tier
            backend = "csd" if self.device.type == "cuda" else "torch"
        self.backend = backend
        if backend != "numpy" and not int32_safe_bound(self._mlp):
            self._demote("weights exceed the int32-safe accumulator bound")

    def _demote(self, why: str) -> None:
        warnings.warn(f"BatchedHWEvaluator: falling back to the numpy int64 "
                      f"backend ({why})", stacklevel=3)
        self.backend = "numpy"
        self.stats["demoted"] = why
        self._dev = None

    # -- cache maintenance -------------------------------------------------

    def _refresh(self, k_from: int) -> None:
        """Dense cache recompute from layer ``k_from`` (init / safety net)."""
        mlp = self._mlp
        n_layers = len(mlp.weights)
        if k_from == 0:
            self._a = [self._x] + [None] * n_layers
            self._acc = [None] * n_layers
        for l in range(k_from, n_layers):
            self._acc[l] = (self._a[l] @ mlp.weights[l].astype(np.int64)
                            + (mlp.biases[l].astype(np.int64) << FRAC))
            self._a[l + 1] = _act_requant_np(self._acc[l],
                                             mlp.activations[l], mlp.q)
        self._refresh_scores()
        self.stats["refreshes"] += 1
        if self.backend != "numpy":
            self._sync_device(None)

    def _refresh_scores(self) -> None:
        """Final-layer score caches: unique integer scores whose row max is
        numpy's first-index argmax (DESIGN.md 7.2)."""
        out = self._a[-1]
        n_out = out.shape[1]
        score = out * n_out + (n_out - 1 - np.arange(n_out, dtype=np.int64))
        if n_out > 1:
            pre = np.maximum.accumulate(score, axis=1)
            suf = np.maximum.accumulate(score[:, ::-1], axis=1)[:, ::-1]
            maxexc = np.empty_like(score)
            maxexc[:, 0] = suf[:, 1]
            maxexc[:, -1] = pre[:, -2]
            if n_out > 2:
                maxexc[:, 1:-1] = np.maximum(pre[:, :-2], suf[:, 2:])
        else:
            maxexc = np.full_like(score, _NEG)
        lab_safe = np.maximum(self._labels, 0)
        slab = np.where(self._labels < 0, _NEG,
                        np.take_along_axis(score, lab_safe[:, None],
                                           axis=1)[:, 0])
        smax = score.max(axis=1)
        self._score = score
        self._maxexc = maxexc
        self._slab = slab
        self._count = int(np.sum(slab == smax))

    # -- evaluation --------------------------------------------------------

    def _pack(self, cands: Sequence[Candidate]):
        """Candidate arrays (row, col, dw, dbias<<FRAC).  The reference pads
        them with no-op candidates to jit-stable sizes; PyTorch compiles
        nothing per shape, so nothing is padded here."""
        k = cands[0].layer
        w_k = self._mlp.weights[k]
        n = len(cands)
        wi = np.zeros(n, np.int64)
        wj = np.zeros(n, np.int64)
        dw = np.zeros(n, np.int64)
        db = np.zeros(n, np.int64)
        for t, c in enumerate(cands):
            wj[t] = c.col
            if c.row >= 0:
                wi[t] = c.row
                dw[t] = int(c.wnew) - int(w_k[c.row, c.col])
            db[t] = c.dbias << FRAC
        return n, wi, wj, dw, db

    def _eval_chunk(self, k: int, cands: Sequence[Candidate]) -> list[float]:
        n, wi, wj, dw, db = self._pack(cands)
        if self.backend == "numpy":
            counts = self._counts_np(k, wi, wj, dw, db)
        else:
            counts = self._device_counts(k, wi, wj, dw, db)
        return [ha_pct(int(c), self.n_val) for c in counts[:n]]

    def _composed_layer(self, cands: Sequence[Candidate]) -> int:
        """Validate a composed (prefix/chain) batch: one layer, and no weight
        mutated twice — weight deltas are taken against the committed network,
        so a repeated weight would compose incorrectly.  (Bias mutations are
        deltas and compose freely.)"""
        k = cands[0].layer
        if any(c.layer != k for c in cands):
            raise ValueError("candidates must share a layer")
        seen = set()
        for c in cands:
            if c.row >= 0:
                if (c.row, c.col) in seen:
                    raise ValueError("composed candidates must target "
                                     "distinct weights")
                seen.add((c.row, c.col))
        return k

    def _spec_safe(self, k: int, dw, db) -> bool:
        """int32 guard for composed (prefix/chain) evaluation: cumulative
        column deltas at layer k, cumulative rank-1 updates at layer k+1, and
        the plain accumulator bounds of every deeper dense-tail layer must
        all stay below 2^31.  Falls back to int64 numpy when violated."""
        amax = 1 << FRAC
        mlp = self._mlp

        def base(l):
            return _layer_accum_bound(mlp.weights[l], mlp.biases[l])

        extra_k = int(np.abs(dw).sum()) * amax + int(np.abs(db).sum())
        if base(k) + extra_k >= 2 ** 31:
            return False
        if k + 1 < len(mlp.weights):
            wmax = int(np.abs(mlp.weights[k + 1]).max() or 1)
            extra = len(dw) * (2 * amax) * wmax
            if base(k + 1) + extra >= 2 ** 31:
                return False
        # dense tail layers see only in-range 8-bit activations, so their
        # standard accumulator bound is the exact requirement
        for l in range(k + 2, len(mlp.weights)):
            if base(l) >= 2 ** 31:
                return False
        return True

    def _prefix_np(self, k: int, wi, wj, dw, db) -> np.ndarray:
        """int64 numpy prefix composition (same algebra as the device prefix
        tail:
        masked-prefix column cumsums, then cumulative rank-1 updates)."""
        mlp = self._mlp
        q = mlp.q
        n_layers = len(mlp.weights)
        b_sz = len(wi)
        deltas = self._a[k][:, wi] * dw[None, :] + db[None, :]    # (Mp, B)
        n_out = self._a[-1].shape[1]
        if k == n_layers - 1:
            onehot = (wj[:, None] == np.arange(n_out)[None, :]).astype(np.int64)
            contrib = deltas.T[:, :, None] * onehot[:, None, :]   # (B, Mp, n)
            acc = self._acc[k][None] + np.cumsum(contrib, axis=0)
            a = _act_requant_np(acc, mlp.activations[k], q)
        else:
            pref = ((wj[None, :] == wj[:, None])
                    & (np.arange(b_sz)[None, :] <= np.arange(b_sz)[:, None]))
            cumdelta = deltas @ pref.astype(np.int64).T           # (Mp, B)
            col_now = self._acc[k][:, wj] + cumdelta
            h_now = _act_requant_np(col_now, mlp.activations[k], q)
            h_prev = _act_requant_np(col_now - deltas, mlp.activations[k], q)
            dcol = h_now - h_prev                                 # (Mp, B)
            w_next = mlp.weights[k + 1]
            step = dcol.T[:, :, None] * w_next[wj][:, None, :]
            acc = self._acc[k + 1][None] + np.cumsum(step, axis=0)
            a = _act_requant_np(acc, mlp.activations[k + 1], q)
            for l in range(k + 2, n_layers):
                b_mp = a.shape[:2]
                acc = (a.reshape(-1, a.shape[2]) @ mlp.weights[l]
                       + (mlp.biases[l].astype(np.int64) << FRAC))
                a = _act_requant_np(acc, mlp.activations[l],
                                    q).reshape(b_mp + (-1,))
        return self._score_counts_np(a)

    def _score_counts_np(self, a: np.ndarray) -> np.ndarray:
        """Correct counts from final activations (B, Mp, n_out)."""
        return _stacked_score_counts(a, self._labels)

    def _counts_np(self, k: int, wi, wj, dw, db) -> np.ndarray:
        """int64 numpy backend: same column / rank-1 / score-trick algebra."""
        mlp = self._mlp
        q = mlp.q
        n_layers = len(mlp.weights)
        acc_col = (self._acc[k][:, wj] + self._a[k][:, wi] * dw[None, :]
                   + db[None, :])                                 # (Mp, B)
        new_col = _act_requant_np(acc_col, mlp.activations[k], q)
        n_out = self._a[-1].shape[1]
        if k == n_layers - 1:
            new_score = new_col * n_out + (n_out - 1 - wj)[None, :]
            smax = np.maximum(self._maxexc[:, wj], new_score)
            slab = np.where(self._labels[:, None] == wj[None, :],
                            new_score, self._slab[:, None])
            return np.sum(slab == smax, axis=0)
        dcol = new_col - self._a[k + 1][:, wj]                    # (Mp, B)
        w_next = mlp.weights[k + 1]
        acc = (self._acc[k + 1][None, :, :]
               + dcol.T[:, :, None] * w_next[wj][:, None, :])     # (B, Mp, n)
        a = _act_requant_np(acc, mlp.activations[k + 1], q)
        for l in range(k + 2, n_layers):
            b_mp = a.shape[:2]
            acc = (a.reshape(-1, a.shape[2]) @ mlp.weights[l]
                   + (mlp.biases[l].astype(np.int64) << FRAC))
            a = _act_requant_np(acc, mlp.activations[l],
                                q).reshape(b_mp + (-1,))
        return self._score_counts_np(a)

    # -- device backend (built lazily; lives in torchtail.py) -------------

    def _device_state(self):
        if self._dev is None:
            from . import torchtail
            self._dev = torchtail.TorchState(self)
        return self._dev

    def _sync_device(self, changed: Optional[dict]) -> None:
        if self._dev is not None:
            self._dev.sync(changed)

    def _device_counts(self, k, wi, wj, dw, db,
                       kind: str = "indep") -> np.ndarray:
        return self._device_state().counts(k, wi, wj, dw, db, kind)


# ---------------------------------------------------------------------------
# Multi-q sweep mode: whole-network batches (DESIGN.md 10)
# ---------------------------------------------------------------------------

class QSweepEvaluator:
    """Batched scorer for whole-network sweeps (the multi-q evaluation mode,
    DESIGN.md 10).

    Where :class:`BatchedHWEvaluator` scores mutations of ONE committed
    network, this evaluator scores a batch of *distinct* ``IntMLP``s sharing
    one (structure, activations) — the Section IV-A minimum-quantization
    search's candidate q levels, or any set of quantized/tuned variants — in
    one stacked ``(Q, M, n)`` integer forward per layer.  Each network
    requantizes with its own ``q`` shift (array-q :func:`act_requant`), and
    the final argmax-vs-label comparison uses the same unique-score trick and
    ``ha_pct`` float expression as the mutation engine, so accuracies are
    bit-identical to the serial ``hardware_accuracy`` oracle.

    Backends: ``numpy`` (host: stacked BLAS matmuls in float32 below the
    2^24 accumulator bound, float64 below 2^53, both exact-integer, and
    per-network int64 loops past that), ``torch`` (int32 stacked matmuls on
    ``device``), and ``csd``, the digit-plane sweep mode (DESIGN.md 11.4):
    every network's weights expand to CSD planes at a shared per-layer
    depth and all q levels run the bit-exact shift-add ASIC datapath
    through the ``csd_qsweep`` kernel in one launch.  ``auto`` resolves to
    ``csd`` on a CUDA device and to ``numpy`` on the CPU.  Demotion is per
    *network*, by the mutation-free accumulator bound
    (:func:`net_accum_bound` / :func:`net_int32_safe`; the csd backend uses
    the tighter CSD absolute-digit bound :func:`csd_net_int32_safe`,
    typically only the highest q levels of a sweep leave the fast tier),
    never per batch.

    Usage (the sweep consumers' contract)::

        ev = QSweepEvaluator(x_val_int, y_val, device="cuda")
        has = ev.evaluate([quantize_mlp(w, b, acts, q) for q in qs])
    """

    def __init__(self, x_val_int: np.ndarray, labels: np.ndarray, *,
                 backend: str = "auto", shard: bool = False,
                 qchunk: int = 4, device="cuda"):
        if backend not in ("auto", "numpy", "torch", "csd"):
            raise ValueError(backend)
        if shard:
            raise NotImplementedError("sharding the validation rows is not "
                                      "ported")
        self.device = resolve_device(device)
        self.n_val = int(x_val_int.shape[0])
        self.qchunk = int(qchunk)
        self.stats = {"eval_calls": 0, "networks": 0, "demoted": 0}
        if backend == "auto":
            # the static rule: the digit-plane kernel on the card; on the
            # CPU the stacked BLAS-float path (exact below 2^53), as the
            # reference picks on CPU hosts
            backend = "csd" if self.device.type == "cuda" else "numpy"
        self.backend = backend
        x = np.asarray(x_val_int, dtype=np.int64)
        self._x = x
        self._xf = x.astype(np.float64)    # exact: activations are 8-bit
        self._xf32 = x.astype(np.float32)
        self._labels = np.asarray(labels, dtype=np.int64)
        self._mp = self.n_val
        self._np_bufs: dict = {}           # per-layer host scratch stacks
        self._dev = None

    def evaluate(self, mlps: Sequence[IntMLP]) -> list[float]:
        """Hardware accuracy (%) of every network, through the oracle's own
        float expression (``ha_pct``) so threshold comparisons downstream are
        bit-identical to serial scoring."""
        return [ha_pct(int(c), self.n_val) for c in self.counts(mlps)]

    def counts(self, mlps: Sequence[IntMLP]) -> np.ndarray:
        """Exact correct-label counts of every network (int64 array)."""
        if not mlps:
            return np.zeros(0, np.int64)
        ref = mlps[0]
        for m in mlps[1:]:
            if [w.shape for w in m.weights] != [w.shape for w in ref.weights]:
                raise ValueError("sweep networks must share a structure")
            if list(m.activations) != list(ref.activations):
                raise ValueError("sweep networks must share activations")
        out = np.empty(len(mlps), np.int64)
        for lo in range(0, len(mlps), self.qchunk):
            chunk = list(mlps[lo:lo + self.qchunk])
            if self.backend == "numpy":
                out[lo:lo + len(chunk)] = self._counts_np(chunk)
            else:
                is_safe = (csd_net_int32_safe if self.backend == "csd"
                           else net_int32_safe)
                safe = [i for i, m in enumerate(chunk) if is_safe(m)]
                unsafe = [i for i in range(len(chunk)) if i not in safe]
                if unsafe:                 # per-level demotion (DESIGN.md 10)
                    self.stats["demoted"] += len(unsafe)
                    out[[lo + i for i in unsafe]] = \
                        self._counts_np([chunk[i] for i in unsafe])
                if safe:
                    out[[lo + i for i in safe]] = \
                        self._device_state().qsweep_counts(
                            [chunk[i] for i in safe])
            self.stats["eval_calls"] += 1
        self.stats["networks"] += len(mlps)
        return out

    def _counts_np(self, mlps: Sequence[IntMLP]) -> np.ndarray:
        """Host path: one network at a time over reusable L2-resident
        buffers.

        Exactness tiers per network, by worst-case accumulator
        (``net_accum_bound``): below 2^24 the stacked ``(Q, M, n)`` forward
        runs in float32, below 2^53 in float64 — both exact, because every
        product and every (blocked / FMA) partial sum is an integer below
        the dtype's mantissa capacity — with ``_float_requant_inplace``
        between layers over per-layer scratch buffers that persist across
        calls (the float32 stack keeps a whole chunk cache-resident,
        DESIGN.md 10).  Networks past the 2^53 bound (astronomical q) fall
        back to the always-exact int64 path, one network at a time.  The
        final argmax-vs-label count is numpy's own first-index ``argmax`` on
        the exact integer-valued activations — the oracle's computation
        verbatim; rows labelled -1 never match.
        """
        out = np.empty(len(mlps), np.int64)
        f32, f64 = [], []
        for i, m in enumerate(mlps):
            bound = net_accum_bound(m)
            if bound < _F32_EXACT and m.q + FRAC < 24:
                f32.append(i)
            elif bound < _F64_EXACT:
                f64.append(i)
            else:
                out[i] = self._count_one_i64(m)
        for dtype, idx in ((np.float32, f32), (np.float64, f64)):
            if idx:
                out[idx] = self._counts_float([mlps[i] for i in idx], dtype)
        return out

    def _npbuf(self, l: int, q: int, n: int, dtype) -> np.ndarray:
        key = (l, np.dtype(dtype).itemsize)
        buf = self._np_bufs.get(key)
        if buf is None or buf.shape[0] < q or buf.shape[2] != n:
            buf = self._np_bufs[key] = np.empty(
                (max(q, self.qchunk), self._mp, n), dtype)
        return buf[:q]

    def _counts_float(self, mlps: Sequence[IntMLP], dtype) -> np.ndarray:
        nq = len(mlps)
        acts = mlps[0].activations
        inv = np.asarray([math.ldexp(1.0, -m.q) for m in mlps],
                         dtype)[:, None, None]              # exact 2^-q
        a = self._xf32 if dtype == np.float32 else self._xf
        for l in range(len(mlps[0].weights)):
            w = np.stack([m.weights[l] for m in mlps]).astype(dtype)
            bsh = np.stack([m.biases[l] for m in mlps]).astype(dtype) \
                * dtype(1 << FRAC)
            acc = self._npbuf(l, nq, w.shape[2], dtype)
            np.matmul(a, w, out=acc)
            acc += bsh[:, None, :]
            _float_requant_inplace(acc, acts[l], inv)
            a = acc
        pred = np.argmax(a, axis=2)                          # (Q, Mp)
        return np.sum(pred == self._labels[None, :], axis=1)

    def _count_one_i64(self, m: IntMLP) -> int:
        a = self._x
        for l, (w, b) in enumerate(zip(m.weights, m.biases)):
            acc = a @ np.asarray(w, np.int64) \
                + (np.asarray(b, np.int64) << FRAC)
            a = _act_requant_np(acc, m.activations[l], m.q)
        return int(np.sum(np.argmax(a, axis=1) == self._labels))

    def _device_state(self):
        if self._dev is None:
            from . import torchtail
            self._dev = torchtail.QSweepTorch(self)
        return self._dev
