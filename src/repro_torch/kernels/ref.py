"""Plain-torch oracles for the kernels, at the reference's path and with
its signatures (counterpart of ``repro/kernels/ref.py``): the allclose
targets of the reference's kernel tests."""
from __future__ import annotations

import math

import torch

from .csd_matvec import csd_matvec_plain
from .qmatmul import qmatmul_plain

__all__ = ["qmatmul_ref", "csd_matvec_ref", "flash_attention_ref"]


def qmatmul_ref(x_i8, w_i8, exp_i32):
    """Exact reference: int32 matmul (wrapping as int32 does), then the
    power-of-two dequant ``* 2^-exp`` in f32."""
    return qmatmul_plain(x_i8, w_i8, exp_i32.to(torch.int32))


def csd_matvec_ref(x_int, planes):
    """Exact reference: sum_d (x @ plane_d) << d, all int32."""
    return csd_matvec_plain(x_int, planes)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Exact (materialized) attention reference for the flash kernel: K
    and V repeated over each group, f32 scores, the causal mask aligned at
    the bottom right (query row i at position ``i + Skv - Sq``), masked
    scores -1e30."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    kk = torch.repeat_interleave(k, n_rep, dim=2).float()
    vv = torch.repeat_interleave(v, n_rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return out.to(q.dtype)
