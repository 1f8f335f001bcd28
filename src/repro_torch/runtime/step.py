"""Step functions: train, prefill and decode (counterpart of
``repro/runtime/step.py``).

``make_train_step`` returns (params, opt_state, batch) -> (params,
opt_state, metrics): the loss and its gradient through autograd (on the card
every attention call of the loss runs the flash kernel forward and its
gradient the flash backward kernels), then the optional compressor,
``clip_by_global_norm_`` (in place: the step owns its gradients) and the
optimizer.  The parameter and optimizer
trees are updated in place and returned (the reference donates them to its
jitted step).  The reference's ``jit_cell`` binds a step to a device mesh
through its sharding rules; it waits for the port's parallelism (ROADMAP.md,
queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.nn.model import Model
from repro_torch.nn.types import ArchConfig
from repro_torch.optim.adamw import AdamW, clip_by_global_norm_
from repro_torch.tree import leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "default_optimizer"]


def default_optimizer(cfg: ArchConfig) -> AdamW:
    return AdamW(state_dtype=cfg.opt_state_dtype)


def _unflatten(like, values):
    """``like``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def make_train_step(model: Model, opt, *, clip: float = 1.0,
                    compressor=None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "xent", "aux"}).  ``compressor`` optionally quantizes the
    gradients before clipping (``repro_torch.optim.compress``)."""

    def train_step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, mets = model.loss(live, batch)
            flat = leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = _unflatten(live, [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(flat, grads)])
        if compressor is not None:
            grads = compressor(grads)
        grads, gnorm = clip_by_global_norm_(grads, clip)
        params, opt_state = opt.apply(params, opt_state, grads)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                                   **{k: v.detach() for k, v in mets.items()}}

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode_step

