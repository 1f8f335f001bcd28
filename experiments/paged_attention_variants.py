#!/usr/bin/env python3
"""Time text variants of ``csrc/paged_attention.cu`` against the source
as it stands, in one process on one card.

    python3 experiments/paged_attention_variants.py NAME=[TRANSFORM[+...]] ...
        [--splits S] [--window W] [--dtype bfloat16|float32]

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  The shape is
``chip_smoke.py``'s kernel phase: q (8, 1, 14, 64), pools (256, 32, 2, 64)
of 24 layers, lengths [1, 33, 100, 257, 511, 640, 900, 1024] with sentinel
tables; ``--splits`` forces at most S splits (default: the rule's).

Each variant is built with the package's nvcc flags, held against
``paged_attention_plain`` at the kernel's tolerances (printed, not
asserted), and timed as ``chip_smoke.py`` times the kernel (CUDA-graph
replays over the 24 layers' pools), in the order a, b, ..., b, a; then
24 calls of each under ``torch.profiler``, for each kernel's own device
time.  Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
"""
import ctypes
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    LOG2E, paged_attention_plain, split_shape, splits, workspace_bytes)

SRC = (build.CSRC / "paged_attention.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    # no combine kernel (wrong results: shows what the combine costs)
    "nocombine": [("  if (e != cudaSuccess || S == 1) return e;\n",
                   "  return e;\n")],
    # no scores, softmax or PV: the walk only waits for its tiles (wrong
    # results: shows what the compute costs)
    "nocompute": [("    if (warp < kMmaWarps && i < w.n) {",
                   "    if (false) {"),
                  ("    for (int g = warp; g < G; g += n_warps) {\n"
                   "      const float* qg",
                   "    for (int g = warp; g < 0; g += n_warps) {\n"
                   "      const float* qg")],
    # one computing warp in the tensor-core kernel, three blocks in flight
    "onewarp": [("constexpr int kMmaWarps = 2;", "constexpr int kMmaWarps = 1;")],
    # the combine launched as an ordinary kernel, after the splits finish
    "nopdl": [("programmaticStreamSerializationAllowed = 1;",
               "programmaticStreamSerializationAllowed = 0;")],
    # the CUDA-core kernel where the tensor-core one would run
    "simt": [("  const bool mma = mma_route(dtype, Hq / Hkv, D, bs);",
              "  const bool mma = false;")],
}


def variant(transforms):
    src = SRC
    for t in transforms:
        for a, b in EDITS[t]:
            if a not in src:
                raise ValueError(f"{t}: the source no longer holds {a!r}")
            src = src.replace(a, b)
    return src


def main():
    args = sys.argv[1:]
    opts = {"--splits": None, "--window": "0", "--dtype": "bfloat16"}
    specs = []
    it = iter(args)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            specs.append(a)
    variants = {}
    for spec in specs:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"pa_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"pa_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"pa_{name}")):
            print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"pa_{name}")))
        f = lib.paged_attention
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    L, B, Hq, Hkv, D, bs, C = 24, 8, 14, 2, 64, 32, 1024
    nb = C // bs
    NB = B * nb
    window = int(opts["--window"])
    dt = getattr(torch, opts["--dtype"])
    S, c = (splits(B, Hkv, nb) if opts["--splits"] is None
            else split_shape(nb, int(opts["--splits"])))
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    vpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda", dtype=dt)
    lens = np.array([1, 33, 100, 257, 511, 640, 900, 1024], np.int32)
    tbl = rng.permutation(NB).reshape(B, nb).astype(np.int32)
    for b in range(B):
        tbl[b, -(-lens[b] // bs):] = NB - 1
    table = torch.from_numpy(tbl).cuda()
    clen = torch.from_numpy(lens).cuda()

    def call(name, q, kp, vp):
        out = torch.empty_like(q)
        ws = None
        if S > 1:
            ws = torch.empty(workspace_bytes(B, Hq, D, S) // 4,
                             dtype=torch.float32, device="cuda")
        err = fns[name](q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        table.data_ptr(), clen.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(),
                        B, Hq, Hkv, D, bs, nb, window, S, c,
                        LOG2E / math.sqrt(D), int(dt == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    want = paged_attention_plain(q, kpool[0], vpool[0], table, clen,
                                 window=window).float()
    atol, rtol = ((cs.ATTN_ATOL, cs.ATTN_RTOL) if dt == torch.bfloat16
                  else (2e-5, 0.0))
    ok = {}
    for n in variants:
        got = call(n, q, kpool[0], vpool[0]).float()
        ok[n] = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
    sets = [(q, kpool[i], vpool[i]) for i in range(L)]
    order = list(variants) + list(variants)[::-1]
    times = {n: [] for n in variants}
    for name in order:
        ms, _ = cs.time_calls(torch, lambda q, k, v, n=name: call(n, q, k, v),
                              sets, 10)
        times[name].append(ms * 1e3)
    print(f"{opts['--dtype']} window {window}, S = {S} splits of {c} blocks "
          f"[{cs.CARD}]: " + ", ".join(
              f"{n} {' / '.join(f'{v:.2f}' for v in ts)} us"
              f"{'' if ok[n] else ' (DISAGREES)'}"
              for n, ts in times.items()))
    from torch.profiler import ProfilerActivity, profile
    for name in variants:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in sets:
                call(name, *a)
            torch.cuda.synchronize()
        per = {}
        for e in cs.device_events(prof):
            t, n = per.get(e.name, (0.0, 0))
            per[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
        print(f"  {name}, device time a launch: " + ", ".join(
            f"{k.split('(')[0][-40:]} {t / n:.2f} us x {n}"
            for k, (t, n) in per.items()))


if __name__ == "__main__":
    main()
