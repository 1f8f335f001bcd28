"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (counterpart of ``repro/launch/train.py``).

Selects an assigned architecture config, optionally at its reduced size
(``--reduced``) or with another vocabulary (``--vocab``), initializes it
from seed 0, and runs the fault-tolerant loop (``runtime/train.py``) with
AdamW on a cosine schedule (20 warm-up steps) over ``TokenPipeline``
batches, ``--compress-grads`` quantizing the gradients to int8 on a
power-of-two scale.  It runs on the card (``--device cpu`` for the CPU):
the dense family's attention through the flash kernels, forward and
backward.  ``--mesh local`` is the one device; ``pod`` and ``multipod``
wait for the port's parallelism (ROADMAP.md, queue 1, item 10).  Prints
the loop's metric records (every ``--log-every`` steps and the last) and
returns the loop.
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
    model = Model(cfg, device=args.device)
    params = model.init(0)
    opt = AdamW(lr=args.lr, state_dtype=cfg.opt_state_dtype,
                schedule=cosine_schedule(args.lr, 20, args.steps))
    opt_state = opt.init(params)
    compressor = pot_compressor() if args.compress_grads else None
    step = make_train_step(model, opt, compressor=compressor)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch)
    loop = TrainLoop(TrainConfig(total_steps=args.steps,
                                 ckpt_every=args.ckpt_every,
                                 ckpt_dir=args.ckpt_dir,
                                 log_every=args.log_every),
                     step, pipe)
    loop.run(params, opt_state)
    for rec in loop.metrics_log:
        print(rec)
    return loop


if __name__ == "__main__":
    main()
