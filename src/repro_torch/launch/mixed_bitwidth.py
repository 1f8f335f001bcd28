"""Mixed bit widths, end to end:
``python -m repro_torch.launch.mixed_bitwidth [--device cuda|cpu] [--out DIR]``.

The counterpart of ``examples/mixed_bitwidth.py``: the per-LAYER version
of the minimum-bitwidth search, priced as a serving ledger and served.

1. qwen2-0.5b at full width (24 layers, d_model 896, vocab 151936, bf16
   activations, f32 masters) with random weights from seed 0, scored by
   the cross-entropy of one validation batch (``TokenPipeline``, 8 x 1024
   tokens, seed 0; the ``serve_quantized`` launcher's):
   ``mixed_bitwidth_search`` on the ladder 8, 6, 5, 4 within a 1e-3
   budget, batched and then serial (they must agree), against the global
   rung it starts from;
2. the searched ``{path: bits}`` served by ``ServeEngine`` (resident as
   mixed int8 / packed int4, 8 slots x 1024 context in 32-token blocks,
   prefill chunk 128 x 4, the ``cuda`` K+V gather and the fused decode
   attention) on 16 seeded requests of 32 new tokens; again with the
   dequantized tree as float parameters, and again on
   ``ReferenceEngine`` at the searched bits;
3. the pendigits network (16-16-10, 25 epochs, seed 3) through
   ``mixed_minq_search``: per-layer q shift-embedded at the global q*,
   each round scored in one stacked ``QSweepEvaluator`` forward (the
   ``csd_qsweep`` kernel on a CUDA device).

The script prints each step's ``Model.loss`` calls, kernel launches and
wall time.  With ``--out DIR`` the LM search's serving sheet is written to
``DIR/mixed_sheet.json``.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hwmodel import ServingCostSheet
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.csd_matvec import csd_qsweep_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                              paged_gather_pair_kernel)
from repro_torch.launch import explore as pendigits_launch
from repro_torch.nn import Model, get_config
from repro_torch.nn.model import resolve_device
from repro_torch.nn.types import ArchConfig
from repro_torch.quant import (MixedBitwidthResult, MixedQResult, dequant,
                               mixed_bitwidth_search, mixed_minq_search,
                               quantize_tree, serving_ledger)
from repro_torch.runtime.serve import (ReferenceEngine, Request, ServeEngine,
                                       summarize)
from repro_torch.train.zaal import TrainResult

ARCH = "qwen2-0.5b"
SEED = 0
SEQ_LEN, BATCH = 1024, 8               # the validation batch
# The example's 1e-4 leaves no room at full width: the global rung would
# sit at 8 bits.  At 2 % (the serve_quantized launcher's budget) the
# global rung is already 4, the ladder's floor, and no greedy round is
# left to play.  At 1e-3 rungs 8, 6 and 5 hold and 4 breaks, so the
# search starts at 5 and tries every one-path demotion to 4.
BUDGET = 1e-3
BIT_LADDER = (8, 6, 5, 4)
# the chip smoke's serving phase: 16 seeded requests on 8 slots
N_REQUESTS, PROMPT_LENS, MAX_NEW = 16, (64, 700), 32
SERVE = dict(max_batch=8, max_context=1024, kv_block_size=32,
             prefill_chunk=128, prefill_batch=4)
KERNELS = {"flash_attention": flash_attention_kernel,
           "paged_gather_pair": paged_gather_pair_kernel,
           "paged_gather": paged_gather_kernel,
           "paged_attention": paged_attention_kernel,
           "csd_qsweep": csd_qsweep_kernel}


@dataclass
class Served:
    """One engine's run over the requests."""
    requests: list
    stats: dict                 # the engine's counters after the run
    summary: dict               # runtime.serve.summarize
    first_logits: torch.Tensor | None   # first decode step (ServeEngine)


@dataclass
class MixedRun:
    """What one run of the pipeline produced."""
    cfg: ArchConfig
    result: MixedBitwidthResult         # the batched search
    serial: MixedBitwidthResult         # the serial search
    global_ledger: ServingCostSheet     # every path at result.start_bits
    uniform8_ledger: ServingCostSheet
    served: dict                # "mixed", "dequant", "reference" -> Served
    engine: ServeEngine         # the mixed-bits engine
    pd_train: TrainResult
    pd_val: tuple               # (x_val_int, y_val)
    pd: MixedQResult
    seconds: dict               # wall time of each step
    loss_calls: dict            # Model.loss calls of each search step
    launches: dict              # step -> {kernel: launches}


def requests_spec(vocab: int) -> list:
    """(prompt, max_new_tokens) of the served requests: ``N_REQUESTS``
    seeded prompts of lengths in ``PROMPT_LENS``."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [(rng.integers(0, vocab, n).astype(np.int32), MAX_NEW)
            for n in lens]


def _serve(engine, spec) -> Served:
    """Run ``spec`` through ``engine``, keeping a ServeEngine's first
    decode logits."""
    first = []
    if isinstance(engine, ServeEngine):
        dispatch = engine._decode

        def recording(toks, pos):
            lg, cache = dispatch(toks, pos)
            if not first:
                first.append(lg.float().clone())
            return lg, cache
        engine._decode = recording
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(spec)]
    engine.run(reqs)
    return Served(requests=reqs, stats=dict(engine.stats),
                  summary=summarize(reqs, engine),
                  first_logits=first[0] if first else None)


def run_pipeline(device="cuda", out=None) -> MixedRun:
    """Search, serve and run the pendigits search on ``device``, at the
    sizes above; with ``out``, save the LM search's sheet there."""
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
    calls, launches, seconds = {}, {}, {}
    step = None

    def ev(p):
        calls[step] = calls.get(step, 0) + 1
        return model.loss(p, val)[0]

    def timed(name, fn):
        nonlocal step
        step = name
        n0 = {k: v.launches for k, v in KERNELS.items()}
        t0 = clock()
        result = fn()
        seconds[name] = clock() - t0
        launches[name] = {k: v.launches - n0[k] for k, v in KERNELS.items()}
        return result

    res = timed("search", lambda: mixed_bitwidth_search(
        params, ev, budget=BUDGET, bit_ladder=BIT_LADDER))
    serial = timed("serial", lambda: mixed_bitwidth_search(
        params, ev, budget=BUDGET, bit_ladder=BIT_LADDER, engine="serial"))
    # the global search's rung is the one the mixed search starts from
    global_ledger = serving_ledger(params, bits=res.start_bits)
    uniform8 = serving_ledger(params, bits=8)

    spec = requests_spec(cfg.vocab)
    kw = dict(SERVE, eos_id=-1, device=dev)
    mixed_kw = dict(kw, quantized=True, quant_bits=res.bits,
                    kv_gather="cuda", decode_kernel="fused")
    _serve(ServeEngine(cfg, params, **mixed_kw),                # warm-up
           [(p, 2) for p, _ in spec[:2]])
    engine = ServeEngine(cfg, params, **mixed_kw)
    served = {"mixed": timed("serve", lambda: _serve(engine, spec))}
    deq = dequant(quantize_tree(params, bits=res.bits), dtype=torch.float32)
    served["dequant"] = timed("serve_dequant", lambda: _serve(
        ServeEngine(cfg, deq, kv_gather="cuda", decode_kernel="fused", **kw),
        spec))
    del deq
    served["reference"] = timed("serve_reference", lambda: _serve(
        ReferenceEngine(cfg, params, max_batch=SERVE["max_batch"],
                        max_context=SERVE["max_context"], eos_id=-1,
                        quantized=True, quant_bits=res.bits, device=dev),
        spec))
    del params
    if out:
        os.makedirs(out, exist_ok=True)
        res.sheet.save(os.path.join(out, "mixed_sheet.json"))

    pd_train, x_val, y_val = timed(
        "pd_train", lambda: pendigits_launch.train_float(dev))
    pd = timed("pd_search", lambda: mixed_minq_search(
        pd_train.weights, pd_train.biases, pendigits_launch.ACTIVATIONS,
        x_val, y_val, device=dev))
    return MixedRun(cfg=cfg, result=res, serial=serial,
                    global_ledger=global_ledger, uniform8_ledger=uniform8,
                    served=served, engine=engine, pd_train=pd_train,
                    pd_val=(x_val, y_val), pd=pd, seconds=seconds,
                    loss_calls=calls, launches=launches)


def same_search(a: MixedBitwidthResult, b: MixedBitwidthResult) -> bool:
    return (a.bits, a.start_bits, a.history) == \
        (b.bits, b.start_bits, b.history)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="directory for mixed_sheet.json")
    args = ap.parse_args(argv)
    r = run_pipeline(args.device, out=args.out)
    res, sec, calls, fl = r.result, r.seconds, r.loss_calls, r.launches

    print("== per-layer mixed-bitwidth search ==")
    print(f"   base loss={res.base:.6f}  mixed loss={res.loss:.6f}  "
          f"start rung={res.start_bits}  rounds={len(res.history)}")
    for path, b in sorted(res.bits.items()):
        print(f"   {path:24s} -> {b} bits")
    for name in ("search", "serial"):
        print(f"   {name}: {sec[name]:.2f} s, {calls[name]} loss calls, "
              f"{fl[name]['flash_attention']} flash launches")
    print(f"   serial {'same' if same_search(res, r.serial) else 'DIFFERENT'}"
          f" bits, start and history")

    print("== serving cost ledger (roofline) ==")
    sheet = res.sheet
    print(f"   mixed : {sheet.weight_bytes()/1e6:7.2f} MB weights, "
          f"AI={sheet.arithmetic_intensity():.2f} ops/byte")
    print(f"   global: {r.global_ledger.weight_bytes()/1e6:7.2f} MB weights "
          f"(uniform {res.start_bits}-bit, same budget)")
    print(f"   8-bit : {r.uniform8_ledger.weight_bytes()/1e6:7.2f} MB "
          f"weights")
    if args.out:
        print(f"   sheet -> {os.path.join(args.out, 'mixed_sheet.json')}")

    print("== serve the searched assignment ==")
    toks = {k: [q.out_tokens for q in s.requests]
            for k, s in r.served.items()}
    for name, step in (("mixed", "serve"), ("dequant", "serve_dequant"),
                       ("reference", "serve_reference")):
        st = r.served[name].stats
        print(f"   {name:9s}: {sec[step]:.2f} s, decode "
              f"{st['decode_tokens'] / st['decode_s']:.1f} tok/s; tokens "
              f"{'==' if toks[name] == toks['mixed'] else '!='} mixed")
    print(f"   mixed first token p50 "
          f"{r.served['mixed'].summary['p50_first_token_s']*1e3:.1f} ms")
    print(f"   engine sheet bits == searched bits: "
          f"{r.engine.serving_sheet.bits_by_layer() == res.bits}")
    print(f"   first output: {toks['mixed'][0]}")

    pd = r.pd
    print("== pendigits: per-layer q via shift-embedding at q* ==")
    print(f"   uniform q*={pd.q_star} ha={pd.base_ha:.2f}%  ->  "
          f"per-layer q={pd.qs} ha={pd.ha:.2f}%  "
          f"[{sec['pd_search']:.2f} s, "
          f"{fl['pd_search']['csd_qsweep']} csd_qsweep launches]")
    for row in pd.sheet.row_strs():
        print(f"   {row}")
    print(f"   mixed weight bytes: {pd.sheet.weight_bytes():.0f}")


if __name__ == "__main__":
    main()
