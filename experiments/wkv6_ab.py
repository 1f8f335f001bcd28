#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 11(a) (the ``wkv6`` kernel against its
plain version and its times at the rwkv6-3b path's shapes) of several
checkouts in one call on one card, in the order given, each in a process
of its own, and each checkout's ``ops.wkv6`` on r, k, v in bf16 as the
bf16 path gives them (a parent's op casts them to f32 first).

    python3 experiments/wkv6_ab.py DIR [DIR ...]

e.g. ``python3 experiments/wkv6_ab.py parent . . parent`` with the
parent commit unpacked (``git archive``) into a git-ignored ``parent/``.
Each DIR holds a ``chip_smoke.py`` and ``src/repro_torch``; its kernels
build into its own ``_build``.  Needs a CUDA card and nvcc.
"""
import os
import subprocess
import sys
from pathlib import Path


def one(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import ops
    cs.CARD = cs.card_line()
    print(f"== {root} [{cs.CARD}]", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.wkv6_kernel_readings(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(B, S, H, hd):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, S, H, hd).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
        return r, k, v, w, randn(H, hd) * 0.5, randn(B, H, hd, hd)

    for shape in [(cs.RWKV_LOSS_BATCH, cs.RWKV_LOSS_SEQ, 40, 64),
                  (cs.HYB_BATCH, cs.hybrid_prefill_len(), 40, 64),
                  (cs.HYB_BATCH, 1, 40, 64)]:
        n = shape[0] * shape[1] * shape[2] * shape[3]
        nbytes = 3 * 2 * n + 4 * (2 * n + 2 * shape[0] * shape[2] * 64 * 64)
        sets = [inputs(*shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        ms, eager = cs.time_calls(torch, ops.wkv6, sets, 5)
        print(f"ops.wkv6 {shape}, r, k, v bf16 [{cs.CARD}]: {ms*1e3:.2f} us "
              f"on the card, {eager*1e3:.2f} us per eager call", flush=True)
        del sets


def main():
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return
    for d in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        d], check=True)


if __name__ == "__main__":
    main()
