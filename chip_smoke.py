#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every CUDA kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together);
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bf16, Hq=14, Hkv=2, D=64, block 32, 8 slots
   of mixed lengths up to 1024, sentinel table entries) -- the gather
   bit-exact, the attention within atol 2e-3 + rtol 1e-2 -- and their
   device times beside the bound and the plain and library times;
3. a small-input reference: a tiny f32 model served on the card through
   both kernels gives the CPU engine's greedy tokens;
4. serving, full width: qwen2-0.5b (24 layers, d_model 896, vocab 151936)
   with random weights from a seed, int8-PoT quantized, block-paged KV,
   ``kv_gather="cuda"``, ``decode_kernel="fused"``, 16 requests; launch
   counters are zeroed just before and read just after.  The same
   requests then go through ``kv_gather="take"``, ``decode_kernel="dense"``
   and the first decode step's logits are compared;
5. a ``torch.profiler`` window over a few engine steps: device busy share
   and the top kernels.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Needs one CUDA card; without one it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2  # bf16 outputs, f32 sums in another order
# first-decode logits of the fused and the dense route: the two reduce the
# softmax in another order and round p to bf16 at other places, and the
# difference passes through the bf16 residual stream of the layers above
LOGIT_REL_TOL = 5e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events):
    """Union of the device events' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def time_calls(torch, fn, arg_sets, reps):
    """Milliseconds per call, both from CUDA events: (replays of a CUDA
    graph that holds one call per entry of ``arg_sets`` -- the device's
    time, without the host's launch gaps; the same calls made eagerly from
    Python -- what a caller pays per call).  ``arg_sets`` cycle through
    every layer's pool, together larger than the 50 MB L2 cache, so each
    call finds its pool cold, as the serving path does."""
    for a in arg_sets[:2]:                      # build, load, allocator
        fn(*a)
    torch.cuda.synchronize()
    n = reps * len(arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in arg_sets:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, eager_ms


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(torch):
    """Each kernel against its plain version at the serving path's shapes,
    and their times."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain)
    from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                                  paged_gather_plain)
    rng = np.random.default_rng(0)
    L, B, Hq, Hkv, D, bs, C = 24, 8, 14, 2, 64, 32, 1024
    nb = C // bs
    NB = B * nb
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    kpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    vpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda", dtype=dt)
    lens = np.array([1, 33, 100, 257, 511, 640, 900, 1024], np.int32)
    tbl = rng.permutation(NB).reshape(B, nb).astype(np.int32)
    for b in range(B):
        tbl[b, -(-lens[b] // bs):] = NB                 # not granted: sentinel
    table = torch.from_numpy(tbl).cuda()
    clen = torch.from_numpy(lens).cuda()
    tbl_c = torch.clamp(table, max=NB - 1)
    results = []

    # --- paged gather, at the prefill dispatch's shape: 4 slot rows
    P = 4
    g_tbl = tbl_c[:P].contiguous()
    got = paged_gather_kernel(kpool[0], g_tbl)
    want = paged_gather_plain(kpool[0], g_tbl)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "paged_gather kernel != plain version")
    sets = [(pool[i], g_tbl) for pool in (kpool, vpool) for i in range(L)]
    ms, eager_ms = time_calls(torch, paged_gather_kernel, sets, 5)
    plain_ms, _ = time_calls(torch, paged_gather_plain, sets, 5)
    flat = g_tbl.reshape(-1).long()
    lib_ms, _ = time_calls(
        torch, lambda leaf, t: leaf.index_select(0, flat), sets, 5)
    block_bytes = bs * Hkv * D * 2
    uniq = int(torch.unique(g_tbl).numel())
    g_bytes = uniq * block_bytes + P * nb * block_bytes + P * nb * 4
    results.append({
        "name": "paged_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_gather.py:34",
        "max_abs_err": 0.0, "ms": ms, "eager_ms": eager_ms,
        "plain_ms": plain_ms, "bound_ms": g_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": lib_ms,
        "library": "torch.index_select",
        "shape": f"pool ({NB},{bs},{Hkv},{D}) bf16, table ({P},{nb}) "
                 f"int32: one prefill dispatch's gather"})

    # --- fused paged attention, at the decode step's shape
    eff = torch.gather(tbl_c, 1, torch.minimum(
        torch.arange(nb, device="cuda")[None, :],
        torch.clamp((clen[:, None].long() - 1) // bs, min=0))).contiguous()
    for window in (0, 200):
        got = ops.paged_attention(q, kpool[0], vpool[0], table, clen,
                                  window=window)
        want = paged_attention_plain(q, kpool[0], vpool[0], table, clen,
                                     window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), "attention output not finite")
        check(torch.allclose(got.float(), want.float(), atol=ATTN_ATOL,
                             rtol=ATTN_RTOL),
              f"paged_attention kernel vs plain: max abs err {err} "
              f"(window {window})")
        print(f"paged_attention window={window}: max abs err {err:.3e} "
              f"(atol {ATTN_ATOL}, rtol {ATTN_RTOL})")
        if window == 0:
            attn_err = err
    sets = [(q, kpool[i], vpool[i], eff, clen) for i in range(L)]
    ms, eager_ms = time_calls(torch, paged_attention_kernel, sets, 10)
    plain_ms, _ = time_calls(torch, paged_attention_plain, sets, 1)
    tokens = int(lens.sum())
    a_bytes = (tokens * Hkv * D * 2 * 2 + 2 * q.numel() * 2
               + table.numel() * 4 + clen.numel() * 4)
    a_flops = 4 * Hq * D * tokens
    bound = max(a_bytes / HBM_BYTES_PER_S, a_flops / BF16_FLOPS) * 1e3
    results.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:122",
        "max_abs_err": attn_err, "ms": ms, "eager_ms": eager_ms,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if a_bytes / HBM_BYTES_PER_S
        >= a_flops / BF16_FLOPS else "operations",
        "library_ms": None,
        "library": "none: no single PyTorch call computes attention "
                   "through a block table",
        "shape": f"q ({B},1,{Hq},{D}) bf16, pools ({NB},{bs},{Hkv},{D}), "
                 f"lengths {lens.tolist()}: one decode step's layer"})
    for r in results:
        print(f"{r['name']}: {r['ms']*1e3:.2f} us on the card "
              f"({r['eager_ms']*1e3:.2f} us per eager call), plain "
              f"{r['plain_ms']*1e3:.2f} us, bound {r['bound_ms']*1e3:.2f} us"
              + (f", library {r['library_ms']*1e3:.2f} us"
                 if r["library_ms"] is not None else ""))
    return results


def tiny_reference_phase(torch):
    """A tiny f32 model served on the card through both kernels gives the
    CPU engine's greedy tokens (the plain versions there)."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                              vocab=64, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (3, 17, 9, 22)]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, eos_id=-1, max_batch=3, max_context=32,
                          prefill_chunk=5, prefill_batch=2, kv_block_size=8,
                          kv_gather="cuda", decode_kernel="fused", device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    check(outs[0] == outs[1], f"tiny model: card {outs[1]} != cpu {outs[0]}")
    print(f"tiny f32 model: card tokens == CPU tokens ({outs[1][0]} ...)")


def serve(torch, cfg, params, reqs_spec, record_first, **kw):
    from repro_torch.runtime.serve import Request, ServeEngine, summarize
    eng = ServeEngine(cfg, params, eos_id=-1, device="cuda", **kw)
    first = {}
    dispatch = eng._decode

    def recording(toks, pos):
        lg, cache = dispatch(toks, pos)
        if record_first and "logits" not in first:
            first["logits"] = lg.float().clone()
        return lg, cache
    eng._decode = recording
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(reqs_spec)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, summarize(reqs, eng), wall, first.get("logits")


def serving_phase(torch):
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_gather import paged_gather_kernel
    from repro_torch.nn import Model, get_config
    cfg = get_config("qwen2-0.5b")                         # full width
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        return tree.numel()
    print(f"qwen2-0.5b params: {numel(params)/1e9:.3f} B (f32), init "
          f"{time.perf_counter()-t0:.2f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 701, 16)
    spec = [(rng.integers(0, cfg.vocab, n).astype(np.int32), 32)
            for n in lens]
    kw = dict(max_batch=8, max_context=1024, kv_block_size=32,
              prefill_chunk=128, prefill_batch=4, quantized=True,
              quant_bits=8)
    main = dict(kw, kv_gather="cuda", decode_kernel="fused")
    serve(torch, cfg, params, spec[:2], False, **main)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    paged_gather_kernel.launches = 0
    paged_attention_kernel.launches = 0
    eng, reqs, summ, wall, lg_fused = serve(torch, cfg, params, spec, True,
                                            **main)
    launches = {"paged_gather": paged_gather_kernel.launches,
                "paged_attention": paged_attention_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "done" and len(r.out_tokens) == 32 for r in reqs),
          "a request did not finish with 32 tokens")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(lg_fused is not None and lg_fused.shape == (8, 1, cfg.vocab)
          and bool(torch.isfinite(lg_fused).all()),
          "first decode logits missing, misshapen or not finite")
    toks = np.array([r.out_tokens for r in reqs])
    check(toks.min() >= 0 and toks.max() < cfg.vocab, "token out of range")
    s = eng.stats
    print(f"serving (fused, cuda gather, int8-PoT): {len(reqs)} requests in "
          f"{wall:.3f} s; prefill {s['prefill_tokens']} tok in "
          f"{s['prefill_s']:.3f} s ({s['prefill_dispatches']} dispatches); "
          f"decode {s['decode_tokens']} tok in {s['decode_s']:.3f} s "
          f"({s['decode_steps']} steps, {summ['decode_tok_s']:.1f} tok/s)")
    print(f"latency: first token p50 {summ['p50_first_token_s']*1e3:.1f} ms "
          f"p99 {summ['p99_first_token_s']*1e3:.1f} ms; total p50 "
          f"{summ['p50_total_s']*1e3:.1f} ms p99 "
          f"{summ['p99_total_s']*1e3:.1f} ms; peak memory "
          f"{peak/2**30:.3f} GiB; resident weights "
          f"{eng.quant_bytes/2**30:.3f} GiB")
    print(f"launches on the main path: {launches}")
    _, ref_reqs, ref_summ, ref_wall, lg_dense = serve(
        torch, cfg, params, spec, True,
        **dict(kw, kv_gather="take", decode_kernel="dense"))
    same = np.mean([a == b for r, q in zip(reqs, ref_reqs)
                    for a, b in zip(r.out_tokens, q.out_tokens)])
    diff = (lg_fused - lg_dense).abs().max().item()
    scale = lg_dense.abs().max().item()
    print(f"take/dense route: {ref_wall:.3f} s, decode "
          f"{ref_summ['decode_tok_s']:.1f} tok/s; identical greedy tokens "
          f"{same*100:.2f} %; first decode logits max abs diff {diff:.4e} "
          f"(max |logit| {scale:.4e}, tolerance {LOGIT_REL_TOL} x max)")
    check(diff <= LOGIT_REL_TOL * scale,
          "fused and dense first-decode logits disagree")
    return launches, eng, spec, cfg


def profile_phase(torch, eng, spec):
    """Device busy share and top kernels over a few engine steps of a
    fresh batch on the main engine (prefill and decode mixed)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import Request
    for i, (p, _) in enumerate(spec[:8]):
        eng.submit(Request(rid=100 + i, prompt=p.copy(), max_new_tokens=16))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = device_events(prof)
    busy = busy_us(evs)
    check(busy > 0, "profiler window recorded no device time")
    by_name = {}
    for e in evs:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    print(f"profile (6 engine steps): wall {wall_us/1e3:.3f} ms, device busy "
          f"{busy/1e3:.3f} ms ({100*busy/wall_us:.2f} %), idle "
          f"{100*(1-busy/wall_us):.2f} %")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:10]:
        print(f"  {t/1e3:9.3f} ms {n:6d} x  {name[:90]}")
    while eng.queue or eng.slots:
        eng.step()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build(["paged_gather", "paged_attention"])
    print(f"build: {time.perf_counter()-t0:.2f} s (paged_gather.cu, "
          f"paged_attention.cu, in parallel)")
    for name in ("paged_gather", "paged_attention"):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    kernels = kernel_phase(torch)
    print(f"kernel phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    tiny_reference_phase(torch)
    print(f"tiny reference phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    launches, eng, spec, cfg = serving_phase(torch)
    print(f"serving phase: {time.perf_counter()-t0:.2f} s")
    profile_phase(torch, eng, spec)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
