"""Device tails for the batched evaluators (DESIGN.md 7.2-7.3, 10): the
counterpart of ``repro/eval/jaxtail.py``.

For the mutation engine (``BatchedHWEvaluator``), :class:`TorchState` keeps
int32 mirrors of the evaluator's caches on its device and computes, per
candidate chunk,

    column update at k  ->  rank-1 update at k+1  ->  dense matmuls k+2..
    ->  unique-score max  ->  per-candidate correct counts

for independent candidates (``core``) or prefix-composed ones
(``spec_core``).  On the ``csd`` backend the dense tail runs through the
bit-exact ``csd_matvec`` shift-add kernel, with each layer's CSD digit
planes expanded on the host, uploaded once and dropped when a commit
touches the layer; on ``torch`` it is an integer matmul
(``repro_torch.core.intmlp.matmul_int``).  The reference's ``lax.scan``
chains are not ported: chains run on the host (``_chain_np``).

For the sweep engine (``QSweepEvaluator``), :class:`QSweepTorch` holds the
validation rows on the device and runs the stacked forward: one (Q, M, n)
integer product per layer over the network stack, per-network array-q
requantization and the same unique-score counts (DESIGN.md 10).  On the
``csd`` backend the per-layer product is the ``csd_qsweep`` digit-plane
kernel, every network's weights expanded to CSD planes at a shared depth.
PyTorch runs eagerly, so nothing is compiled or padded per shape.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.intmlp import FRAC, act_requant, matmul_int
from repro_torch.kernels import ops

_NEG = -(1 << 30)


def _score_counts(act_a: torch.Tensor, lab: torch.Tensor,
                  lab_safe: torch.Tensor) -> torch.Tensor:
    """Correct counts from final activations (B, Mp, n_out): the unique
    integer score ``a * n + (n - 1 - j)`` whose row max is numpy's
    first-index argmax (DESIGN.md 7.2)."""
    n_out = act_a.shape[2]
    pen = n_out - 1 - torch.arange(n_out, dtype=act_a.dtype,
                                   device=act_a.device)
    score = act_a * n_out + pen
    smax = score.amax(dim=2)                                      # (B, Mp)
    slab = torch.gather(score, 2, lab_safe[None, :, None].expand(
        score.shape[0], -1, 1))[..., 0]
    slab = torch.where(lab[None, :] < 0, _NEG, slab)
    return (slab == smax).sum(dim=1)


class TorchState:
    """Device mirrors of a ``BatchedHWEvaluator``'s caches, and its tails."""

    def __init__(self, ev):
        self.ev = ev
        self.device = ev.device
        n_layers = len(ev._mlp.weights)
        self._planes: list = [None] * n_layers
        self.lab = self._put(ev._labels, torch.int64)
        self.lab_safe = self._put(np.maximum(ev._labels, 0), torch.int64)
        self.W = [None] * n_layers
        self.bsh = [None] * n_layers
        self.sync(None)

    def _put(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64)).to(
            device=self.device, dtype=dtype)

    def sync(self, changed: Optional[dict]) -> None:
        """Refresh device mirrors after a commit.  ``changed`` (from the
        evaluator's commit) names the dirtied cache entries; None means a full
        rebuild (init / dense refresh)."""
        ev = self.ev
        n_layers = len(ev._mlp.weights)
        if changed is None:
            w_layers = range(n_layers)
            a_dirty = set(range(n_layers + 1))
            acc_dirty = set(range(n_layers))
            scores = True
            self.a = [None] * (n_layers + 1)
            self.acc = [None] * n_layers
        else:
            w_layers = [changed["layer"]]
            a_dirty, acc_dirty = changed["a"], changed["acc"]
            scores = changed["scores"]
        for l in w_layers:
            self.W[l] = self._put(ev._mlp.weights[l])
            self.bsh[l] = self._put(ev._mlp.biases[l].astype(np.int64) << FRAC)
            self._planes[l] = None
        for l in a_dirty:
            self.a[l] = self._put(ev._a[l])
        for l in acc_dirty:
            self.acc[l] = self._put(ev._acc[l])
        if scores:
            self.maxexc = self._put(np.clip(ev._maxexc, _NEG, None))
            self.slab = self._put(ev._slab)

    def _need_planes(self, k: int) -> None:
        for l in range(k + 2, len(self.ev._mlp.weights)):
            if self._planes[l] is None:
                self._planes[l] = torch.from_numpy(
                    ops.csd_expand(self.ev._mlp.weights[l])).to(self.device)

    def counts(self, k: int, wi, wj, dw, db,
               kind: str = "indep") -> np.ndarray:
        """Correct counts of a candidate chunk (``kind="indep"``: each
        candidate alone; ``"spec"``: entry c with candidates 0..c applied)."""
        use_csd = (self.ev.backend == "csd"
                   and k + 2 < len(self.ev._mlp.weights))
        if use_csd:
            self._need_planes(k)
        dev = self.device
        wi = torch.as_tensor(wi, dtype=torch.int64, device=dev)
        wj = torch.as_tensor(wj, dtype=torch.int64, device=dev)
        dw = torch.as_tensor(dw, dtype=torch.int32, device=dev)
        db = torch.as_tensor(db, dtype=torch.int32, device=dev)
        fn = self._spec_core if kind == "spec" else self._core
        return fn(k, use_csd, wi, wj, dw, db).cpu().numpy()

    def _dense_tail(self, k: int, act_a: torch.Tensor,
                    use_csd: bool) -> torch.Tensor:
        """Dense layers k+2.. over the (B, Mp, n) activations."""
        mlp = self.ev._mlp
        b_sz = act_a.shape[0]
        for l in range(k + 2, len(mlp.weights)):
            x2 = act_a.reshape(-1, act_a.shape[2])
            if use_csd:
                y = ops.csd_matvec(x2, planes=self._planes[l])
            else:
                y = matmul_int(x2, self.W[l])
            act_a = act_requant(y + self.bsh[l][None, :], mlp.activations[l],
                                mlp.q).reshape(b_sz, -1, self.W[l].shape[1])
        return act_a

    def _core(self, k, use_csd, wi, wj, dw, db) -> torch.Tensor:
        mlp = self.ev._mlp
        a, acc, q = self.a, self.acc, mlp.q
        n_out = mlp.weights[-1].shape[1]
        acc_col = (acc[k][:, wj] + a[k][:, wi] * dw[None, :]
                   + db[None, :])                                 # (Mp, B)
        new_col = act_requant(acc_col, mlp.activations[k], q)
        if k == len(mlp.weights) - 1:
            new_score = new_col * n_out + (n_out - 1 - wj)[None, :]
            smax = torch.maximum(self.maxexc[:, wj], new_score)
            slab_c = torch.where(self.lab[:, None] == wj[None, :],
                                 new_score, self.slab[:, None])
            return (slab_c == smax).sum(dim=0)
        dcol = new_col - a[k + 1][:, wj]                          # (Mp, B)
        w_rows = self.W[k + 1][wj]                                # (B, n_next)
        acc2 = acc[k + 1][None] + dcol.T[:, :, None] * w_rows[:, None, :]
        act_a = act_requant(acc2, mlp.activations[k + 1], q)      # (B, Mp, n)
        act_a = self._dense_tail(k, act_a, use_csd)
        return _score_counts(act_a, self.lab, self.lab_safe)

    def _spec_core(self, k, use_csd, wi, wj, dw, db) -> torch.Tensor:
        """Prefix composition: entry c = candidates 0..c all applied."""
        mlp = self.ev._mlp
        a, acc, q = self.a, self.acc, mlp.q
        n_out = mlp.weights[-1].shape[1]
        deltas = a[k][:, wi] * dw[None, :] + db[None, :]          # (Mp, B)
        if k == len(mlp.weights) - 1:
            onehot = (wj[:, None] == torch.arange(
                n_out, device=self.device)[None, :]).to(torch.int32)
            contrib = deltas.T[:, :, None] * onehot[:, None, :]
            acc_p = acc[k][None] + torch.cumsum(contrib, dim=0,
                                                dtype=torch.int32)
            act_a = act_requant(acc_p, mlp.activations[k], q)
        else:
            iota = torch.arange(len(wj), device=self.device)
            pref = ((wj[None, :] == wj[:, None])
                    & (iota[None, :] <= iota[:, None])).to(torch.int32)
            cumdelta = matmul_int(deltas, pref.T)   # (Mp, B): sum over t <= c
            col_now = acc[k][:, wj] + cumdelta      # of the same column
            h_now = act_requant(col_now, mlp.activations[k], q)
            h_prev = act_requant(col_now - deltas, mlp.activations[k], q)
            dcol = h_now - h_prev                                 # (Mp, B)
            w_rows = self.W[k + 1][wj]                            # (B, n_next)
            step = dcol.T[:, :, None] * w_rows[:, None, :]
            acc_p = acc[k + 1][None] + torch.cumsum(step, dim=0,
                                                    dtype=torch.int32)
            act_a = act_requant(acc_p, mlp.activations[k + 1], q)
            act_a = self._dense_tail(k, act_a, use_csd)
        return _score_counts(act_a, self.lab, self.lab_safe)


class QSweepTorch:
    """Device rows and the stacked forward of the multi-q sweep mode
    (DESIGN.md 10)."""

    def __init__(self, ev):
        self.ev = ev
        self.device = ev.device
        self.x = torch.as_tensor(ev._x).to(device=self.device,
                                           dtype=torch.int32)
        lab = torch.as_tensor(ev._labels).to(self.device)
        self.lab = lab
        self.lab_safe = torch.clamp(lab, min=0)

    def _stack(self, arrays, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.stack([np.asarray(x, np.int64)
                                         for x in arrays])).to(
            device=self.device, dtype=dtype)

    def qsweep_counts(self, mlps) -> np.ndarray:
        """Exact correct counts of the int32-safe networks in one stacked
        forward.  On the ``csd`` backend the per-layer weight stacks ride as
        CSD digit planes (shared depth per layer) through ``csd_qsweep``."""
        n_layers = len(mlps[0].weights)
        # forward_int zips: surplus activation entries never run
        acts = mlps[0].activations[:n_layers]
        a = self.x[None].expand(len(mlps), -1, -1)
        qcol = torch.as_tensor([m.q for m in mlps], dtype=torch.int32,
                               device=self.device)[:, None, None]
        for l in range(n_layers):
            if self.ev.backend == "csd":     # stacked shift-add datapath
                planes = torch.from_numpy(ops.csd_expand_stack(
                    [m.weights[l] for m in mlps])).to(self.device)
                acc = ops.csd_qsweep(a, planes)
            else:
                acc = matmul_int(a, self._stack([m.weights[l] for m in mlps]))
            bsh = self._stack([np.asarray(m.biases[l], np.int64) << FRAC
                               for m in mlps])
            a = act_requant(acc + bsh[:, None, :], acts[l], qcol)
        return _score_counts(a, self.lab, self.lab_safe).cpu().numpy() \
            .astype(np.int64)
