"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (counterpart of ``repro/launch/train.py``).

Selects an assigned architecture config, optionally at its reduced size
(``--reduced``) or with another vocabulary (``--vocab``), initializes it
from seed 0, and runs the fault-tolerant loop (``runtime/train.py``) with
AdamW on a cosine schedule (20 warm-up steps) over ``TokenPipeline``
batches, ``--compress-grads`` quantizing the gradients to int8 on a
power-of-two scale.  It runs on the card (``--device cpu`` for the CPU),
through the hand-written kernels forward and backward: flash attention
(dense and hybrid), the linear scan (the hybrid's RG-LRU) and the WKV
recurrence (RWKV6).  ``--mesh local`` is the one device; ``pod`` and
``multipod`` wait for the port's parallelism (ROADMAP.md, queue 1, item
10).  Prints the loop's metric records (every ``--log-every`` steps and
the last) and returns the loop.

:func:`train` is the loop built from a config, which :func:`main` calls
after parsing the command line; a caller with a config of its own (a cut
depth, say) calls it directly.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.data.tokens import TokenPipeline
from repro_torch.nn import Model, get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.compress import pot_compressor
from repro_torch.runtime.step import make_train_step
from repro_torch.runtime.train import TrainConfig, TrainLoop


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, ckpt_dir: str = TrainConfig.ckpt_dir,
          ckpt_every: int = 50, log_every: int = TrainConfig.log_every,
          compress_grads: bool = False, device: str = "cuda"):
    """Initialize ``cfg`` from seed 0 on ``device`` and run the
    fault-tolerant loop: AdamW on a cosine schedule (20 warm-up steps)
    over ``TokenPipeline`` batches of ``batch`` rows of ``seq`` tokens.
    Returns the loop."""
    model = Model(cfg, device=device)
    params = model.init(0)
    opt = AdamW(lr=lr, state_dtype=cfg.opt_state_dtype,
                schedule=cosine_schedule(lr, 20, steps))
    opt_state = opt.init(params)
    compressor = pot_compressor() if compress_grads else None
    step = make_train_step(model, opt, compressor=compressor)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    loop = TrainLoop(TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=ckpt_dir, log_every=log_every),
                     step, pipe)
    loop.run(params, opt_state)
    return loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"],
                    default="local")
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=TrainConfig.log_every)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            f"wait for its parallelism (ROADMAP.md, queue 1, item 10)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)
    loop = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, log_every=args.log_every,
                 compress_grads=args.compress_grads, device=args.device)
    for rec in loop.metrics_log:
        print(rec)
    return loop


if __name__ == "__main__":
    main()
