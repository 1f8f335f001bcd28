"""ZAAL, the paper's training algorithm (Section VI), in PyTorch: the
counterpart of ``repro/train/zaal.py``.

Feedforward MLP trainer with the feature set the paper lists: conventional
and stochastic gradient descent plus Adam; Xavier / He / fully-random
initialization; early stopping on a validation set, iteration-count and
loss-saturation stopping; activation functions sigmoid, hsig, tanh, htanh,
lin, relu, satlin, softmax.

Training runs in float32 (as the paper does, offline); the hardware pipeline
(repro_torch.core) quantizes and tunes the result.  The minibatch order is
the reference's (``np.random.default_rng(cfg.seed).permutation``); the
initial weights come from a ``torch.Generator`` and so differ from the
reference's ``jax.random`` draws: carry the reference's parameters across
with :func:`params_from_numpy` where the two must start alike.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["TrainConfig", "TrainResult", "train", "mlp_apply", "init_params",
           "params_from_numpy", "make_update", "ACTIVATIONS"]

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "hsig": lambda y: torch.clamp(y / 2 + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "htanh": lambda y: torch.clamp(y, -1.0, 1.0),
    "lin": lambda y: y,
    "relu": torch.relu,
    "satlin": lambda y: torch.clamp(y, 0.0, 1.0),
    "softmax": lambda y: torch.softmax(y, dim=-1),
}


@dataclass
class TrainConfig:
    structure: tuple            # e.g. (16, 16, 10): inputs, hidden..., outputs
    activations: tuple = None   # per layer; default htanh hidden + sigmoid out
    init: str = "xavier"        # xavier | he | random
    optimizer: str = "adam"     # adam | sgd | gd
    lr: float = 3e-3
    batch_size: int = 256       # ignored for optimizer='gd' (full batch)
    epochs: int = 150
    early_stop_patience: int = 20
    loss_saturation_eps: float = 1e-6
    seed: int = 0

    def __post_init__(self):
        if self.activations is None:
            n_hidden = len(self.structure) - 2
            self.activations = tuple(["htanh"] * n_hidden + ["sigmoid"])


def init_params(cfg: TrainConfig, generator: torch.Generator,
                device="cuda") -> list:
    """Initial parameters, ``[{"w": (n_in, n_out), "b": (n_out,)}, ...]``
    float32, drawn from ``generator`` (on the CPU, then moved)."""
    params = []
    dims = list(cfg.structure)
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        if cfg.init == "xavier":
            w = torch.randn((n_in, n_out), generator=generator) \
                * np.sqrt(2.0 / (n_in + n_out))
        elif cfg.init == "he":
            w = torch.randn((n_in, n_out), generator=generator) \
                * np.sqrt(2.0 / n_in)
        elif cfg.init == "random":
            w = torch.rand((n_in, n_out), generator=generator) - 0.5
        else:
            raise ValueError(cfg.init)
        params.append({"w": w.to(device), "b": torch.zeros(n_out,
                                                           device=device)})
    return params


def params_from_numpy(weights, biases, device="cuda") -> list:
    """Parameters from numpy arrays (e.g. the reference's), as float32."""
    return [{"w": torch.tensor(np.asarray(w), dtype=torch.float32,
                               device=device),
             "b": torch.tensor(np.asarray(b), dtype=torch.float32,
                               device=device)}
            for w, b in zip(weights, biases)]


def mlp_apply(params, activations, x: torch.Tensor) -> torch.Tensor:
    a = x
    for p, act in zip(params, activations):
        a = ACTIVATIONS[act](a @ p["w"] + p["b"])
    return a


def loss_fn(params, activations, x, y_onehot) -> torch.Tensor:
    """MSE against one-hot targets (classic pendigits-era training; stable
    for sigmoid/hsig output layers, which saturate under raw
    cross-entropy)."""
    out = mlp_apply(params, activations, x)
    return torch.mean(torch.sum((out - y_onehot) ** 2, dim=-1))


@dataclass
class TrainResult:
    weights: list               # list[np.ndarray (n_in, n_out)] float64
    biases: list
    activations: tuple
    train_acc: float
    val_acc: float
    loss_history: list = field(default_factory=list)


def make_update(cfg: TrainConfig):
    """One optimizer step, ``update(params, opt, x, y_onehot, step) ->
    (params, opt, loss)``: Adam (bias-corrected moments, as the reference
    writes it), or plain gradient descent for ``sgd`` and ``gd``."""
    activations = cfg.activations

    def grads_of(params, x, y):
        leaves = [p.detach().requires_grad_(True)
                  for layer in params for p in (layer["w"], layer["b"])]
        tree = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                for i in range(len(params))]
        loss = loss_fn(tree, activations, x, y)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [p.detach() for p in leaves], list(grads)

    def regroup(flat):
        return [{"w": flat[2 * i], "b": flat[2 * i + 1]}
                for i in range(len(flat) // 2)]

    def adam_update(params, opt, x, y, step):
        loss, ps, gs = grads_of(params, x, y)
        m, v = opt
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = [b1 * mi + (1 - b1) * g for mi, g in zip(m, gs)]
        v = [b2 * vi + (1 - b2) * g * g for vi, g in zip(v, gs)]
        new = [p - cfg.lr * (mi / (1 - b1 ** step))
               / (torch.sqrt(vi / (1 - b2 ** step)) + eps)
               for p, mi, vi in zip(ps, m, v)]
        return regroup(new), (m, v), loss

    def sgd_update(params, opt, x, y, step):
        loss, ps, gs = grads_of(params, x, y)
        return regroup([p - cfg.lr * g for p, g in zip(ps, gs)]), opt, loss

    return adam_update if cfg.optimizer == "adam" else sgd_update


def init_opt(params) -> tuple:
    """Zero Adam moments (m, v), flat in ``make_update``'s leaf order."""
    flat = [p for layer in params for p in (layer["w"], layer["b"])]
    return ([torch.zeros_like(p) for p in flat],
            [torch.zeros_like(p) for p in flat])


def train(cfg: TrainConfig, x_train: np.ndarray, y_train: np.ndarray,
          x_val: np.ndarray, y_val: np.ndarray, *, device="cuda",
          params=None) -> TrainResult:
    """x_* are float features in [-1, 1); y_* integer class labels.
    ``params`` (e.g. from :func:`params_from_numpy`) replaces the seeded
    initialization."""
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                             device=device)
    opt = init_opt(params)
    update = make_update(cfg)

    x_tr = torch.as_tensor(np.asarray(x_train), dtype=torch.float32,
                           device=device)
    y_onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(y_train), device=device),
        cfg.structure[-1]).to(torch.float32)
    x_va = torch.as_tensor(np.asarray(x_val), dtype=torch.float32,
                           device=device)
    y_val_np = np.asarray(y_val)

    def val_acc(params) -> float:
        with torch.no_grad():
            pred = mlp_apply(params, cfg.activations, x_va).argmax(dim=-1)
        return float(np.mean(pred.cpu().numpy() == y_val_np)) * 100

    n = x_tr.shape[0]
    full_batch = cfg.optimizer == "gd" or cfg.batch_size >= n
    rng = np.random.default_rng(cfg.seed)
    best_val, best_params, patience = -1.0, params, 0
    losses = []
    step = 0
    prev_loss = np.inf
    for _ in range(cfg.epochs):
        if full_batch:
            step += 1
            params, opt, loss = update(params, opt, x_tr, y_onehot, step)
            epoch_loss = float(loss)
        else:
            perm = torch.as_tensor(rng.permutation(n), device=device)
            batch_losses = []
            for s in range(0, n, cfg.batch_size):
                idx = perm[s:s + cfg.batch_size]
                step += 1
                params, opt, loss = update(params, opt, x_tr[idx],
                                           y_onehot[idx], step)
                batch_losses.append(loss)
            # one host read per epoch, summed left to right as the
            # reference does
            epoch_loss = 0.0
            for bl in torch.stack(batch_losses).tolist():
                epoch_loss += bl
            epoch_loss /= max(1, len(batch_losses))
        losses.append(epoch_loss)
        va = val_acc(params)
        if va > best_val:
            best_val, best_params, patience = va, params, 0
        else:
            patience += 1
            if patience >= cfg.early_stop_patience:
                break
        if abs(prev_loss - epoch_loss) < cfg.loss_saturation_eps:
            break
        prev_loss = epoch_loss

    params = best_params
    with torch.no_grad():
        tr_pred = mlp_apply(params, cfg.activations, x_tr).argmax(dim=-1)
    train_acc = float(np.mean(tr_pred.cpu().numpy() == np.asarray(y_train))) \
        * 100
    return TrainResult(
        weights=[p["w"].detach().cpu().numpy().astype(np.float64)
                 for p in params],
        biases=[p["b"].detach().cpu().numpy().astype(np.float64)
                for p in params],
        activations=cfg.activations,
        train_acc=train_acc, val_acc=best_val, loss_history=losses)
