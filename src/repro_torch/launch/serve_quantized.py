"""The LM-scale quantization pipeline, end to end:
``python -m repro_torch.launch.serve_quantized [--device cuda|cpu]``.

The counterpart of the first three sections of
``examples/serve_quantized.py``, on qwen2-0.5b at full width (24 layers,
d_model 896, 14 query / 2 KV heads, vocab 151936, bf16 activations, f32
masters) with random weights from seed 0:

1. the minimum-bitwidth search (paper IV-A at LM scale): the ladder
   8, 6, 5, 4 scored by the cross-entropy of one validation batch
   (``TokenPipeline``, 8 x 1024 tokens) within a 2 % budget, on the batched
   engine and again on the serial one, which must agree;
2. the smallest-left-shift exponent rescale (the IV-C analogue), one raise
   per matmul at most;
3. serving at the chosen bits through ``ReferenceEngine`` (int8-PoT
   weights, 8 rows x 2048 context): 16 seeded prompts of 128-1536 tokens,
   32 new tokens each, with the serving ledger of the served bits.

On a CUDA device every ``Model.loss`` call and every prefill attends
through the flash-attention kernel, 24 launches each; the script prints
the launches of each step.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hwmodel import ServingCostSheet
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.nn import Model, get_config
from repro_torch.nn.model import resolve_device
from repro_torch.nn.types import ArchConfig
from repro_torch.quant import min_bitwidth_search, quant_bytes, sls_rescale
from repro_torch.runtime.serve import ReferenceEngine, Request, percentile

ARCH = "qwen2-0.5b"
SEED = 0
SEQ_LEN, BATCH = 1024, 8               # the validation batch
BUDGET, MAX_RAISE = 0.02, 1
N_REQUESTS, PROMPT_LENS, MAX_NEW = 16, (128, 1536), 32
MAX_BATCH, MAX_CONTEXT = 8, 2048


@dataclass
class PTQRun:
    """What one run of the pipeline produced."""
    cfg: ArchConfig
    bits: int                   # the batched search's choice
    history: list               # [("float", loss), (bits, loss), ...]
    serial: tuple               # (bits, history) of the serial search
    raised: int                 # exponents the rescale raised
    float_bytes: int            # the float parameters' bytes
    quant_bytes: int            # the rescaled tree's resident bytes
    ledger: ServingCostSheet    # serving ledger at the served bits
    engine: ReferenceEngine
    requests: list
    token_s: dict               # rid -> (first token s, last token s)
    seconds: dict               # wall time of each step
    loss_calls: dict            # Model.loss calls of each search step
    launches: dict              # flash-attention launches of each step
    peak_bytes: int | None      # device memory peak while serving


def run_pipeline(device="cuda") -> PTQRun:
    """Search, rescale and serve on ``device``, at the sizes above."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    model = Model(cfg, device=dev)
    params = model.init(SEED)
    val = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ_LEN,
                        global_batch=BATCH, seed=SEED).batch(0)
    val = {k: torch.as_tensor(v, device=dev) for k, v in val.items()}
    calls = {}
    launches = {}
    seconds = {}
    step = None

    def ev(p):
        calls[step] = calls.get(step, 0) + 1
        return model.loss(p, val)[0]

    def timed(name, fn):
        nonlocal step
        step = name
        n0 = flash_attention_kernel.launches
        t0 = clock()
        out = fn()
        seconds[name] = clock() - t0
        launches[name] = flash_attention_kernel.launches - n0
        return out

    qt, bits, history = timed("search", lambda: min_bitwidth_search(
        params, ev, budget=BUDGET))
    _, s_bits, s_history = timed("serial", lambda: min_bitwidth_search(
        params, ev, budget=BUDGET, engine="serial"))
    qt, raised = timed("rescale", lambda: sls_rescale(
        qt, ev, budget=BUDGET, max_raise=MAX_RAISE))
    float_bytes = quant_bytes(params)
    q_bytes = quant_bytes(qt)
    del qt

    token_s = {}
    t_start = [0.0]

    def on_token(rid, idx, tok):
        t = time.perf_counter() - t_start[0]
        first = token_s.get(rid, (t, t))[0]
        token_s[rid] = (first, t)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                    on_token=on_token)
            for i, p in enumerate(prompts(cfg.vocab))]
    eng = ReferenceEngine(cfg, params, max_batch=MAX_BATCH,
                          max_context=MAX_CONTEXT, eos_id=-1,
                          quantized=True, quant_bits=bits, device=dev)
    del params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def serve():
        t_start[0] = clock()
        return eng.run(reqs)
    timed("serve", serve)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return PTQRun(cfg=cfg, bits=bits, history=history,
                  serial=(s_bits, s_history), raised=raised,
                  float_bytes=float_bytes, quant_bytes=q_bytes,
                  ledger=eng.serving_sheet, engine=eng, requests=reqs,
                  token_s=token_s, seconds=seconds, loss_calls=calls,
                  launches=launches, peak_bytes=peak)


def prompts(vocab: int) -> list:
    """The served prompts: ``N_REQUESTS`` seeded token arrays of lengths
    drawn from ``PROMPT_LENS[0]..PROMPT_LENS[1]``."""
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [rng.integers(0, vocab, m).astype(np.int32) for m in sizes]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    r = run_pipeline(args.device)
    sec, calls, fl = r.seconds, r.loss_calls, r.launches

    print("== minimum-bitwidth search (paper IV-A at LM scale) ==")
    for b, loss in r.history:
        print(f"   bits={b}: loss={loss:.6f}")
    print(f"   chosen bits={r.bits}  [batched: {sec['search']:.2f} s, "
          f"{calls['search']} loss calls; serial: {sec['serial']:.2f} s, "
          f"{calls['serial']} loss calls, "
          f"{'same' if r.serial == (r.bits, r.history) else 'DIFFERENT'} "
          f"bits and history]")

    print("== sls exponent rescale (paper IV-C analogue) ==")
    print(f"   raised exponents on {r.raised} tensors within budget "
          f"[{sec['rescale']:.2f} s, {calls['rescale']} loss calls]")
    print(f"   serving bytes: float={r.float_bytes/1e6:.1f}MB  "
          f"quant={r.quant_bytes/1e6:.1f}MB  "
          f"({r.float_bytes/r.quant_bytes:.2f}x smaller)")

    s = r.engine.stats
    done = [q for q in r.requests if q.status == "done"]
    first = [r.token_s[q.rid][0] for q in done]
    total = [r.token_s[q.rid][1] for q in done]
    print(f"== serving at bits={r.bits} (ReferenceEngine, int8-PoT) ==")
    print(f"   served {len(done)}/{len(r.requests)} in {sec['serve']:.2f} s "
          f"on {args.device}: prefill {s['prefill_tokens']} tok in "
          f"{s['prefill_s']:.2f} s, decode {s['decode_tokens']} tok in "
          f"{s['decode_s']:.2f} s "
          f"({s['decode_tokens']/max(s['decode_s'], 1e-9):.1f} tok/s)")
    print(f"   first token p50={percentile(first, 50)*1e3:.1f}ms "
          f"p99={percentile(first, 99)*1e3:.1f}ms; total "
          f"p50={percentile(total, 50)*1e3:.1f}ms "
          f"p99={percentile(total, 99)*1e3:.1f}ms")
    tot = r.ledger.to_dict()["totals"]
    print(f"   ledger: weights {tot['weight_bytes']/1e6:.1f}MB, "
          f"{tot['ops_per_token']/1e6:.1f} Mop/token, intensity "
          f"{tot['arithmetic_intensity']:.3f} op/B")
    print(f"   flash_attention launches: {fl}")
    print(f"   first output: {r.requests[0].out_tokens}")


if __name__ == "__main__":
    main()
