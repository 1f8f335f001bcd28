"""AdamW and SGD-momentum optimizers on the port's parameter trees
(counterpart of ``repro/optim/adamw.py``).

The reference's functions are pure; here ``apply`` updates the parameter
and state tensors IN PLACE and returns the same trees, as the reference's
train step donates them to XLA.  The update arithmetic is f32 whatever the
leaves' dtypes, and the moments are stored in ``state_dtype``: the largest
assigned model (arctic-480b) keeps them in bf16, because f32 moments alone
would not fit (DESIGN.md 4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamW", "Sgd", "clip_by_global_norm", "clip_by_global_norm_",
           "global_norm", "cosine_schedule"]

# elements of a leaf that AdamW updates at a time: 256 MiB of f32, so a
# chunk's few temporaries stay small beside the state
CHUNK = 1 << 26


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, leaves added in the
    reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), each in its own dtype; the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float):
    """:func:`clip_by_global_norm` scaling each leaf IN PLACE, bit for bit
    the same values: a train step owns its gradients, and a scaled copy of
    them all would be one more gradient tree at the peak."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> lr: linear warm-up over ``warmup`` steps, then a cosine decay
    to 0 at ``total``; f32 arithmetic."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    schedule: object = None     # optional step -> lr

    def init(self, params) -> dict:
        dt = getattr(torch, self.state_dtype)
        first = leaves(params)[0]
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                    device=p.device), params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                    device=p.device), params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    @torch.no_grad()
    def apply(self, params, state, grads):
        """One step: params and the moments updated in place; returns
        (params, the new state).  A leaf is updated ``CHUNK`` elements at a
        time (each element's arithmetic is its own, so the bits are the
        same), which keeps the temporaries of a multi-GiB leaf (a stack of
        experts, an embedding) to a few chunks."""
        count = state["count"] + 1
        lr = self.schedule(count) if self.schedule else self.lr
        b1, b2 = self.b1, self.b2
        c = count.float()
        bias1, bias2 = 1 - b1 ** c, 1 - b2 ** c
        for p, m, v, g in zip(leaves(params), leaves(state["m"]),
                              leaves(state["v"]), leaves(grads)):
            decay = p.ndim >= 2   # decoupled weight decay on matrices only
            # views of the leaves (``view`` refuses a strided leaf, which
            # a copy would leave un-updated)
            for pc, mc, vc, gc in zip(*(
                    t.view(-1).split(CHUNK) for t in (p, m, v)),
                    g.reshape(-1).split(CHUNK)):
                g32 = gc.float()
                # f32 moments are updated in place (``.float()`` is the
                # tensor itself), the same roundings as m * b1 + (1 - b1) g
                m32 = mc.float().mul_(b1).add_((1 - b1) * g32)
                v32 = vc.float().mul_(b2).add_((1 - b2) * g32 * g32)
                step = (m32 / bias1) / (torch.sqrt(v32 / bias2) + self.eps)
                if decay:
                    step = step + self.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * step)
                if m32 is not mc:
                    mc.copy_(m32)
                    vc.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "count": count}


@dataclass(frozen=True)
class Sgd:
    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params) -> dict:
        return {"mom": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves(params)[0].device)}

    @torch.no_grad()
    def apply(self, params, state, grads):
        for p, mo, g in zip(leaves(params), leaves(state["mom"]),
                            leaves(grads)):
            mo.copy_(mo * self.momentum + g.to(mo.dtype))
            p.copy_(p.float() - self.lr * mo.float())
        return params, {"mom": state["mom"], "count": state["count"] + 1}
