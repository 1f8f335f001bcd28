"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(counterpart of ``repro/launch/serve.py``).

Builds the paged serving engine on the card (``--device cpu`` for the
CPU), optionally int8-PoT quantized, serves a demo request batch through
the admission queue, and reports per-request latency percentiles plus
prefill/decode throughput.  ``--kv-gather cuda`` routes the block-table
gather through the CUDA kernel; ``--decode-kernel fused`` runs decode
attention straight from the KV block pool through the fused CUDA kernel.
``--engine reference`` runs the reference's continuous-batching-lite
``ReferenceEngine`` instead (whole-prompt prefill through the
flash-attention kernel).  The MoE family (``--arch qwen2-moe-a2.7b``,
``--arch arctic-480b --reduced``) serves through either engine, its
experts' products in cuBLAS.  The hybrid family (``--arch recurrentgemma-9b``)
always serves through ``ReferenceEngine``, as in the reference: its RG-LRU
layers run the linear-scan kernel and its local attention the
flash-attention kernel.  So does the RWKV6 family (``--arch rwkv6-3b``,
family ``ssm``): each layer's time mix runs the ``wkv6`` kernel once a
prefill or decode step.  The audio family (``--arch whisper-base``) goes
to ``ReferenceEngine`` too and fails there with ``KeyError: 'frames'``,
as in the reference: the engine prefills tokens only.  So does the VLM
family (``--arch llava-next-34b``), with ``KeyError: 'patch_embeds'``.
Parameters are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.nn import Model, get_config
from repro_torch.runtime.serve import (ReferenceEngine, Request, ServeEngine,
                                       summarize)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4,
                    help="KV slots (paged) / decode batch (reference)")
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--prefill-batch", type=int, default=1,
                    help="prefill chunks ingested per engine step (one "
                         "fixed-shape batched dispatch)")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="block-paged KV block size (0 = contiguous slot "
                         "rows); must divide --context")
    ap.add_argument("--kv-gather", choices=("take", "cuda"), default="take",
                    help="block-table gather route (block-paged mode only)")
    ap.add_argument("--decode-kernel",
                    choices=("auto", "dense", "reference", "fused"),
                    default="dense",
                    help="decode attention route (block-paged mode only): "
                         "gather+dense, the block-sequential reference, the "
                         "fused paged-attention kernel, or auto (the "
                         "measured-dispatch cache's pick, else dense)")
    ap.add_argument("--admission", choices=("reject", "truncate"),
                    default="truncate")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request queue deadline in seconds")
    ap.add_argument("--engine", choices=("paged", "reference"),
                    default="paged")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = Model(cfg, device=args.device).init(args.seed)
    if args.engine == "reference" or cfg.family not in ("dense", "moe"):
        eng = ReferenceEngine(cfg, params, max_batch=args.batch,
                              max_context=args.context, eos_id=-1,
                              quantized=args.quantized, quant_bits=args.bits,
                              temperature=args.temperature,
                              admission=args.admission, device=args.device)
    else:
        eng = ServeEngine(cfg, params, max_batch=args.batch,
                          max_context=args.context, eos_id=-1,
                          quantized=args.quantized, quant_bits=args.bits,
                          temperature=args.temperature,
                          prefill_chunk=args.prefill_chunk,
                          prefill_batch=args.prefill_batch,
                          kv_block_size=args.kv_block_size,
                          kv_gather=args.kv_gather,
                          decode_kernel=args.decode_kernel,
                          admission=args.admission, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32),
                    max_new_tokens=args.max_new,
                    deadline_s=args.deadline)
            for i in range(args.requests)]
    t0 = time.time()
    eng.run(reqs)
    wall = time.time() - t0
    print(f"served {len(reqs)} requests in {wall:.2f}s on {eng.device} "
          f"(engine={args.engine}, quantized={args.quantized})")
    print(f"prefill: {eng.stats['prefill_tokens']} tok in "
          f"{eng.stats['prefill_s']:.2f}s; decode: "
          f"{eng.stats['decode_tokens']} tok in {eng.stats['decode_s']:.2f}s "
          f"({eng.stats['decode_tokens']/max(eng.stats['decode_s'],1e-9):.1f}"
          f" tok/s)")
    if isinstance(eng, ServeEngine):
        s = summarize(reqs, eng)
        print(f"latency: first-token p50={s['p50_first_token_s']*1e3:.1f}ms "
              f"p99={s['p99_first_token_s']*1e3:.1f}ms; total "
              f"p50={s['p50_total_s']*1e3:.1f}ms "
              f"p99={s['p99_total_s']*1e3:.1f}ms; "
              f"done={s['done']} rejected={s['rejected']} "
              f"expired={s['expired']} truncated={s['truncated']}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out_tokens}")


if __name__ == "__main__":
    main()
