#!/usr/bin/env python3
"""Time text variants of ``csrc/wkv6_bwd.cu`` against the source as it
stands, in one process on one card.

    python3 experiments/wkv6_bwd_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape B,S,H,hd] ... [--dtype bfloat16|float32] [--sass DIR]

``NAME=`` with no transform is the source itself.  A transform is a key
of ``EDITS``: ``acc4`` (four partial sums a dot product), ``nopad``
(staged rows unpadded: float4 broadcasts to two column runs conflict in
the banks), ``tc4`` (4 steps a chunk at hd = 64, two blocks an SM),
``sw16`` (16 columns a row owner and rows a column owner, so twice the
threads).  Variants that give wrong results, to see what a part costs:
``nofetch`` (no chunk inputs loaded after the first), ``nock`` (no
checkpoint loaded), ``nopass1`` (no checkpoint walk), ``norebuild`` (no
states rebuilt, no dr), ``norow`` (no row owners' backward steps),
``nocol`` (no column owners' steps).
``--shape`` names the shapes (default: the rwkv6-3b loss (8, 1024, 40,
64)); ``--dtype`` r, k, v's (default bfloat16).  ``--sass DIR`` writes
each variant's SASS (``cuobjdump -sass``) into DIR.

Each variant is built with the package's nvcc flags, its ptxas lines
printed, its gradients' largest difference from ``wkv6_bwd_plain`` over
their largest magnitude printed (not asserted), and timed as
``chip_smoke.py`` times the kernel (CUDA-graph replays over input sets of
at least twice the L2), in the order a, b, ..., b, a.  Needs a CUDA card
and nvcc; builds into ``src/repro_torch/kernels/_build/``.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import bwd_tiling, wkv6_bwd_plain  # noqa: E402

SRC = (build.CSRC / "wkv6_bwd.cu").read_text()

_FETCH1 = ("    if (c + 2 < nck)\n"
           "      fetch<HD, BF16, false>(pr, pk, pv, pw, pdy, r, k, v, w, dy,"
           " at0, step,\n                             S, (c + 1) * K::TC);\n")
_FETCH2 = ("    if (c > 0)\n"
           "      fetch<HD, BF16, true>(pr, pk, pv, pw, pdy, r, k, v, w, dy,"
           " at0, step,\n                            S, (c - 1) * K::TC);\n")

# name -> [(old text, new text), ...]
EDITS = {
    "acc4": [("float p = 0.0f;", "float pp[4] = {};"),
             ("p = fmaf(yq[x], s[4 * q + x], p);",
              "pp[x] = fmaf(yq[x], s[4 * q + x], pp[x]);"),
             ("p = fmaf(g[4 * q + x], kq[x], p);",
              "pp[x] = fmaf(g[4 * q + x], kq[x], pp[x]);"),
             ("        p = lanes_sum<K::NSR>(p);",
              "        const float p = lanes_sum<K::NSR>(pp[0] + pp[1] + "
              "pp[2] + pp[3]);"),
             ("        p = lanes_sum<K::NSC>(p);",
              "        const float p = lanes_sum<K::NSC>(pp[0] + pp[1] + "
              "pp[2] + pp[3]);"),
             ("float pw_ = 0.0f, pk_ = 0.0f;",
              "float aw[4] = {}, ak[4] = {};"),
             ("pw_ = fmaf(g[4 * q + x], sq[x], pw_);",
              "aw[x] = fmaf(g[4 * q + x], sq[x], aw[x]);"),
             ("pk_ = fmaf(g[4 * q + x], vq[x], pk_);",
              "ak[x] = fmaf(g[4 * q + x], vq[x], ak[x]);"),
             ("        pw_ = lanes_sum<K::NSR>(pw_);",
              "        const float pw_ = lanes_sum<K::NSR>(aw[0] + aw[1] + "
              "aw[2] + aw[3]);"),
             ("        pk_ = lanes_sum<K::NSR>(pk_);",
              "        const float pk_ = lanes_sum<K::NSR>(ak[0] + ak[1] + "
              "ak[2] + ak[3]);")],
    "nopad": [("static constexpr int PAD = 4;",
               "static constexpr int PAD = 0;")],
    "tc4": [("static constexpr int TC = HD <= 32 ? 16 : 8;",
             "static constexpr int TC = HD <= 32 ? 16 : 4;"),
            ("__launch_bounds__(Bwd<HD>::THREADS, 1)",
             "__launch_bounds__(Bwd<HD>::THREADS, HD == 64 ? 2 : 1)")],
    "sw16": [("static constexpr int SW = CB < 32 ? CB : 32;",
              "static constexpr int SW = CB < 16 ? CB : 16;"),
             ("static constexpr int SH = HD < 32 ? HD : 32;",
              "static constexpr int SH = HD < 16 ? HD : 16;")],
    # wrong results, to see what a part costs
    "nofetch": [(_FETCH1, ""), (_FETCH2, "")],
    "nock": [("      if (c > 0) {\n        const float4* src",
              "      if (c < 0) {\n        const float4* src")],
    "nopass1": [("for (int c = 0; c + 1 < nck; ++c) {",
                 "for (int c = 0; c + 1 < 0; ++c) {")],
    "norebuild": [("      for (int t = 0; t < n; ++t) {\n        float4* "
                   "slot",
                   "      for (int t = 0; t < 0; ++t) {\n        float4* "
                   "slot")],
    "norow": [("      for (int t = n - 1; t >= 0; --t) {\n        const "
               "float4* slot",
               "      for (int t = -1; t >= 0; --t) {\n        const "
               "float4* slot")],
    "nocol": [("      for (int t = n - 1; t >= 0; --t) {\n        const float "
               "dyj",
               "      for (int t = -1; t >= 0; --t) {\n        const float "
               "dyj")],
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
    specs, shapes, dtype, sass, i = [], [], torch.bfloat16, None, 0
    while i < len(args):
        if args[i] == "--shape":
            shapes.append(tuple(int(v) for v in args[i + 1].split(",")))
            i += 2
        elif args[i] == "--dtype":
            dtype = getattr(torch, args[i + 1])
            i += 2
        elif args[i] == "--sass":
            sass = Path(args[i + 1])
            i += 2
        else:
            specs.append(args[i])
            i += 1
    shapes = shapes or [(cs.RWKV_LOSS_BATCH, cs.RWKV_LOSS_SEQ, 40, 64)]
    torch.zeros(1, device="cuda")       # the runtime up before the libraries
    variants = {}
    for spec in specs or ["a="]:
        name, _, parts = spec.partition("=")
        variants[name] = ([p for p in parts.split("+") if p],
                          variant([p for p in parts.split("+") if p]))
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, (_, text) in variants.items():
        (vdir / f"wkvb_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"wkvb_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"wkvb_{name}")):
            if "ILi64E" in fn:
                print(f"  {name} {fn[-40:]}: {line}")
        path = build.library_path(f"wkvb_{name}")
        if sass is not None:
            sass.mkdir(parents=True, exist_ok=True)
            with open(sass / f"wkvb_{name}.sass", "w") as f:
                subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                                str(path)], stdout=f, check=False)
        lib = ctypes.CDLL(str(path))
        f = lib.wkv6_bwd
        f.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, r, k, v, w, u, s0, dy, dsT):
        B, S, H, hd = r.shape
        tc = 4 if "tc4" in variants[name][0] and hd == 64 \
            else bwd_tiling(hd).tc
        nck = -(-S // tc)
        f32 = dict(dtype=torch.float32, device=r.device)
        outs = [torch.empty(r.shape, **f32) for _ in range(4)]
        du = torch.empty((H, hd), **f32)
        ds0 = torch.empty_like(s0)
        ck = torch.empty(B * H * nck * hd * hd, **f32)
        du_part = torch.empty((B, H, hd), **f32)
        ncb = bwd_tiling(hd).ncb
        part = torch.empty((3, ncb) + tuple(r.shape) if ncb > 1 else (1,),
                           **f32)
        err = fns[name](*(t.data_ptr() for t in (r, k, v, w, u, s0, dy, dsT,
                                                 *outs, du, ds0, ck, du_part,
                                                 part)),
                        B, S, H, hd, int(r.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return (*outs, du, ds0)

    cs.CARD = cs.card_line()
    print(cs.CARD)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, hd):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
        return (r, k, v, w, randn(H, hd) * 0.5, randn(B, H, hd, hd),
                randn(B, S, H, hd), randn(B, H, hd, hd) * 0.1)

    names = list(variants)
    order = names + names[::-1]
    es = torch.finfo(dtype).bits // 8
    for shape in shapes:
        args = inputs(*shape)
        want = wkv6_bwd_plain(*args)
        agree = {}
        for n in names:
            got = call(n, *args)
            agree[n] = max(((g - x).abs().max() / x.abs().max()).item()
                           for g, x in zip(got, want))
        del want
        nbytes = cs.wkv_bwd_bytes(*shape, es)
        sets = [inputs(*shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        times = {n: [] for n in names}
        for n in order:
            ms, _ = cs.time_calls(torch, lambda *a, n=n: call(n, *a), sets,
                                  3)
            times[n].append(ms * 1e3)
        b_us = nbytes / cs.HBM_BYTES_PER_S * 1e6
        s_us = cs.wkv_bwd_slots(*shape) / cs.F32_SLOTS_PER_S * 1e6
        print(f"{shape} {str(dtype)[6:]} [{cs.CARD}], bound "
              f"{max(b_us, s_us):.2f} us (issue slots {s_us:.2f}, bytes "
              f"{b_us:.2f}), {len(sets)} input sets:")
        for n in names:
            print(f"  {n} ({'+'.join(variants[n][0]) or 'source'}): "
                  f"{' / '.join(f'{v:.2f}' for v in times[n])} us "
                  f"({100 * max(b_us, s_us) / times[n][0]:.1f} % of the "
                  f"bound; gradients within {agree[n]:.2e} of their "
                  f"largest magnitudes)")
        del sets


if __name__ == "__main__":
    main()
