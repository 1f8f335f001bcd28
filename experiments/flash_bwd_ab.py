#!/usr/bin/env python3
"""Time the flash-attention backward of several checkouts in one call on
one card, in the order given, each in a process of its own: for each DIR,
``chip_smoke.flash_bwd_timing`` (phase 15 (a)'s timing: CUDA-graph replays
of the backward over input sets twice the L2, each kernel's device time,
autograd through the plain version, ``scaled_dot_product_attention``'s
backward) at qwen2-0.5b's loss shape (8, 1024, 14 / 2, 64) and at D = 128,
GQA 8:1 (8, 1024, 16 / 2, 128), bf16, causal.

    python3 experiments/flash_bwd_ab.py DIR [DIR ...]

e.g. ``python3 experiments/flash_bwd_ab.py parent . . parent`` with the
parent commit unpacked (``git archive``) into a git-ignored ``parent/``.
Each DIR holds a ``chip_smoke.py`` and ``src/repro_torch``; its kernels
build into its own ``_build``.  Needs a CUDA card and nvcc.
"""
import os
import subprocess
import sys
from pathlib import Path

SHAPES = {"qwen2-0.5b loss": (8, 1024, 14, 2, 64),
          "D = 128 GQA 8:1 loss": (8, 1024, 16, 2, 128)}


def one(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import build
    cs.CARD = cs.card_line()
    print(f"== {root} [{cs.CARD}]", flush=True)
    build.build(("flash_attention", "flash_attention_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, dt):
        B, S, Hq, Hkv, D = shape
        return [torch.randn(s, generator=gen, device="cuda", dtype=dt)
                for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                          (B, S, Hq, D))]

    for name, shape in SHAPES.items():
        r = cs.flash_bwd_timing(torch, inputs, shape)
        print(f"AB {root.name or root} {name}: {r['ms']*1e3:.2f} us; "
              + " / ".join(f"{k} {v*1e3:.2f}" for k, v in
                           r["kernel_ms"].items()) + " us", flush=True)
        torch.cuda.empty_cache()


def main():
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return
    for d in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        d], check=True)


if __name__ == "__main__":
    main()
