"""Where ServeEngine's fused and dense decode routes part on qwen2-moe.

    python3 experiments/moe_route_divergence.py [--layers N]

qwen2-moe-a2.7b at full width (random weights from seed 0, the first N
layers, all 24 by default) prefills the serving cell's first 8 prompts into
a block pool (32-token blocks, 1024 a slot), then takes one decode step on
the fused route (``kv_gather="cuda"``, ``decode_kernel="fused"``) and one
on the dense route (``"take"``, ``"dense"``) from the same cache, in f32
and again with the weights cast to bf16.  The dense step keeps the fused
step's expert choices (its gates come from its own probabilities), so the
two differ only by rounding; a layer's line gives the relative distance
(l2 and max) of the MoE block's input and output between the routes, and
the first line how many experts the dense route's own router would have
picked that the fused step did not, layer by layer.  A third step takes the dense route with its own routing, as
``ServeEngine`` does.  Needs one CUDA card; prints the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.nn import Model, blocks, get_config  # noqa: E402

B, CONTEXT, BS, CHUNK = 8, 1024, 32, 128


def prefill(m, params, spec, table):
    """Chunked prefill of ``spec``'s prompts, one slot each; returns (the
    cache, each row's greedy first token, the prompt lengths)."""
    cache = m.init_cache(table.numel(), BS)
    lens = np.array([len(p) for p, _ in spec])
    first = np.zeros(B, np.int64)
    for off in range(0, int(lens.max()), CHUNK):
        toks = np.zeros((B, CHUNK), np.int32)
        nval = np.ones(B, np.int32)
        offs = np.full(B, CONTEXT, np.int32)        # done rows: all-drop
        for i, (p, _) in enumerate(spec):
            if off < len(p):
                n = min(CHUNK, len(p) - off)
                toks[i, :n], nval[i], offs[i] = p[off:off + n], n, off
        lg, cache = m.prefill_chunks(params, cache, toks, np.arange(B), offs,
                                     nval, block_table=table,
                                     kv_gather="cuda")
        done = (offs < CONTEXT) & (off + nval >= lens)
        first[done] = lg.argmax(-1).cpu().numpy()[done]
    return cache, first, lens


def step(m, params, cache, tok, lens, table, route, pinned):
    """One decode step on ``route`` under ``chip_smoke.RouteProbe`` (it
    records the routing, or replays ``pinned``'s); records every layer's
    MoE input and output.  Returns (logits, inputs, outputs, probe)."""
    probe = cs.RouteProbe(blocks, pinned)
    moe_apply = blocks.moe_apply
    ins, outs = [], []

    def apply(p, x, cfg):
        ins.append(x.float())
        y, aux = moe_apply(p, x, cfg)
        outs.append(y.float())
        return y, aux

    blocks.moe_apply, blocks.moe_route = apply, probe
    probe.in_decode = True
    kv = dict(cuda=("cuda", "fused"), dense=("take", "dense"))[route]
    lg, _ = m.decode_step(params, cache, tok[:, None], lens,
                          block_table=table, kv_gather=kv[0],
                          decode_kernel=kv[1])
    probe.detach()
    blocks.moe_apply = moe_apply
    return lg.float(), ins, outs, probe


def rel(a, b):
    return (((a - b).norm() / b.norm()).item(),
            ((a - b).abs().max() / b.abs().max()).item())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    build.build(("paged_gather", "paged_attention"))
    cfg = get_config(cs.MOE_ARCH)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = Model(cfg, device="cuda").init(0)
    spec = cs.serving_spec(cfg.vocab)[:B]
    table = torch.arange(B * (CONTEXT // BS), device="cuda") \
        .reshape(B, CONTEXT // BS)
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            cs.cast_tree(params, torch.bfloat16)
        m = Model(dataclasses.replace(cfg, dtype=dtype), device="cuda")
        cache, tok, lens = prefill(m, params, spec, table)
        lg_f, in_f, out_f, rec = step(m, params, cache, tok, lens, table,
                                      "cuda", None)
        lg_d, in_d, out_d, pin = step(m, params, cache, tok, lens, table,
                                      "dense", rec.decode)
        lg_u, *_ = step(m, params, cache, tok, lens, table, "dense", None)
        print(f"{dtype}: the dense route's own router flips by layer "
              f"{[f for f, _ in pin.flips]} (of {pin.flips[0][1]} choices a "
              f"layer)")
        for i in range(cfg.n_layers):
            a, b = rel(in_f[i], in_d[i]), rel(out_f[i], out_d[i])
            print(f"  layer {i:2d}: MoE input rel (l2, max) {a[0]:.3e} "
                  f"{a[1]:.3e}; output {b[0]:.3e} {b[1]:.3e}; output rms "
                  f"{out_f[i].pow(2).mean().sqrt().item():.3f}")
        r, u = rel(lg_f, lg_d), rel(lg_f, lg_u)
        print(f"{dtype}: first decode logits rel (l2, max) {r[0]:.4e} "
              f"{r[1]:.4e} with the experts pinned, {u[0]:.4e} {u[1]:.4e} "
              f"with the dense route's own; max |logit| "
              f"{lg_d.abs().max().item():.4f}")


if __name__ == "__main__":
    main()
