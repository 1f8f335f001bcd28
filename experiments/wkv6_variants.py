#!/usr/bin/env python3
"""Time text variants of ``csrc/wkv6.cu`` against the source as it
stands, in one process on one card.

    python3 experiments/wkv6_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape B,S,H,hd] ... [--dtype bfloat16|float32]

``NAME=`` with no transform is the source itself.  A transform is a key
of ``EDITS``.  Sizes of ``Tiling<HD>`` (at hd = 64 unless named):
``t8`` / ``t32`` (steps a ring stage, every hd), ``ns3`` / ``ns4``
(stages in the ring, every hd), ``cb16`` / ``cb64`` (columns a block),
``r8`` (8 key rows a thread, so P = hd / 8 lanes a column group, every
hd above 16), ``c2`` / ``c8`` (2 / 8 columns a thread, every hd / every
hd above 16), ``u2`` / ``u8`` (steps a consumer reduces together),
``lb3`` (launch bounds asking for 3 blocks an SM, not 4).
Variants that give wrong results, to see what bounds a step:
``nowait`` (no chunk ring wait: consumers neither wait on ``full`` /
``ready`` nor release ``done``, the producer refills without waiting),
``noout`` (no output sum), ``noshfl`` (no exchange over the lanes),
``noupd`` (no state update), ``copy`` (the step route moves the state
and computes nothing).  So a variant differs from the
source by its edits only.  ``--shape`` names the shapes (default: the
rwkv6-3b loss (8, 1024, 40, 64), the first ReferenceEngine prefill batch
and a decode step (4, 1, 40, 64)); ``--dtype`` r, k, v's (default
bfloat16, as the bf16 path gives them).

Each variant is built with the package's nvcc flags, its ptxas lines
printed, its state held bit for bit and y within ``WKV_Y_TOL`` against
``wkv6_plain`` (printed, not asserted), and timed as ``chip_smoke.py``
times the kernel (CUDA-graph replays over input sets of at least twice
the L2), in the order a, b, ..., b, a.  Needs a CUDA card and nvcc;
builds into ``src/repro_torch/kernels/_build/``.
"""
import ctypes
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.wkv6 import ROUTES, route, wkv6_plain  # noqa: E402

SRC = (build.CSRC / "wkv6.cu").read_text()

_P = ("  static constexpr int R = 4;              // key rows a "
      "thread, 4 | R\n")
_CB = "  static constexpr int CB = HD == 16 ? 16 : 32;"
_WAIT = ("    mbar_wait(&full[sc], ph);\n"
         "    mbar_wait(&ready[sc], ph);\n")
_OUT = "        o[c] = fmaf(ri, s[x][c], o[c]);\n"
_UPD = ("        s[x][c] = __fadd_rn(__fmul_rn(wi, s[x][c]), "
        "__fmul_rn(ki, v[c]));\n")
_SHFL = [("      o[n] += __shfl_xor_sync(0xffffffffu, o[n + k], off);",
          "      o[n] += o[n + k];"),
         ("    o[0] += __shfl_xor_sync(0xffffffffu, o[0], off);",
          "    o[0] += o[0];"),
         ("        o[x][n] += __shfl_xor_sync(0xffffffffu, o[x][n + k], off);",
          "        o[x][n] += o[x][n + k];"),
         ("        o[n][0] = keep + __shfl_xor_sync(0xffffffffu, send, off);",
          "        o[n][0] = keep + send;"),
         ("      o[0][0] += __shfl_xor_sync(0xffffffffu, o[0][0], off);",
          "      o[0][0] += o[0][0];")]

# name -> [(old text, new text), ...]
EDITS = {
    "t8": [("static constexpr int T = 16;", "static constexpr int T = 8;")],
    "t32": [("static constexpr int T = 16;", "static constexpr int T = 32;")],
    "ns3": [("static constexpr int NS = 2;", "static constexpr int NS = 3;")],
    "ns4": [("static constexpr int NS = 2;", "static constexpr int NS = 4;")],
    "cb16": [(_CB, "  static constexpr int CB = HD == 64 ? 16 : "
                   "HD == 16 ? 16 : 32;")],
    "cb64": [(_CB, "  static constexpr int CB = HD == 64 ? 64 : "
                   "HD == 16 ? 16 : 32;")],
    "r8": [(_P, "  static constexpr int R = HD == 16 ? 4 : 8;\n")],
    "c2": [("static constexpr int C = HD == 16 ? 2 : 4;",
            "static constexpr int C = 2;")],
    "c8": [("static constexpr int C = HD == 16 ? 2 : 4;",
            "static constexpr int C = HD == 16 ? 2 : 8;")],
    "u2": [("static constexpr int U = 4;", "static constexpr int U = 2;")],
    "u8": [("static constexpr int U = 4;", "static constexpr int U = 8;")],
    "lb3": [("HD == 64 ? 4 : 2;", "HD == 64 ? 3 : 2;")],
    # wrong results, to see what bounds a step
    "nowait": [(_WAIT, ""),
               ("    mbar_arrive(&done[sc]);\n", ""),
               ("        mbar_wait(&done[sp], (cp / NS) & 1);\n", ""),
               ("      mbar_wait(&done[sp], (cp / NS) & 1);\n", "")],
    "noout": [(_OUT, "")],
    "noshfl": _SHFL,
    "noupd": [(_UPD, "")],
    # the step route's state in and out, nothing computed
    "copy": [("  for (int t = 0; t < S; ++t) {\n    if (t > 0) {",
              "  for (int t = 0; t < 0; ++t) {\n    if (t > 0) {")],
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
    specs, shapes, dtype, i = [], [], torch.bfloat16, 0
    while i < len(args):
        if args[i] == "--shape":
            shapes.append(tuple(int(v) for v in args[i + 1].split(",")))
            i += 2
            continue
        if args[i] == "--dtype":
            dtype = getattr(torch, args[i + 1])
            i += 2
            continue
        specs.append(args[i])
        i += 1
    shapes = shapes or [(cs.RWKV_LOSS_BATCH, cs.RWKV_LOSS_SEQ, 40, 64),
                        (cs.HYB_BATCH, cs.hybrid_prefill_len(), 40, 64),
                        (cs.HYB_BATCH, 1, 40, 64)]
    variants = {}
    for spec in specs or ["a="]:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"wkv_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"wkv_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"wkv_{name}")):
            print(f"  {name} {fn[-40:]}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"wkv_{name}")))
        f = lib.wkv6
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, r, k, v, w, u, s0):
        y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        sS = torch.empty_like(s0)
        err = fns[name](*(t.data_ptr() for t in (r, k, v, w, u, s0, y, sS)),
                        *r.shape[:3], r.shape[3],
                        int(r.dtype == torch.bfloat16),
                        ROUTES.index(route(r.shape[1])),
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return y, sS

    cs.CARD = cs.card_line()
    print(cs.CARD)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, hd):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
        return r, k, v, w, randn(H, hd) * 0.5, randn(B, H, hd, hd)

    names = list(variants)
    order = names + names[::-1]
    es = torch.finfo(dtype).bits // 8
    for shape in shapes:
        args = inputs(*shape)
        wy, ws = wkv6_plain(*args)
        agree = {}
        for n in names:
            y, sS = call(n, *args)
            rel = ((y - wy).abs() / wy.abs().amax(-1, keepdim=True)).max()
            agree[n] = (bool(torch.equal(sS.view(torch.int32),
                                         ws.view(torch.int32))),
                        rel.item())
        nbytes = cs.wkv_bytes(*shape, es)
        sets = [inputs(*shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        times = {n: [] for n in names}
        for n in order:
            ms, _ = cs.time_calls(torch, lambda *a, n=n: call(n, *a), sets,
                                  5)
            times[n].append(ms * 1e3)
        b_us = nbytes / cs.HBM_BYTES_PER_S * 1e6
        s_us = cs.wkv_slots(*shape) / cs.F32_SLOTS_PER_S * 1e6
        print(f"{shape} {str(dtype)[6:]} [{cs.CARD}], bound "
              f"{max(b_us, s_us):.2f} us (issue slots {s_us:.2f}, bytes "
              f"{b_us:.2f}), {len(sets)} input sets: " + ", ".join(
                  f"{n} {' / '.join(f'{v:.2f}' for v in times[n])} us "
                  f"({times[n][0] / shape[1]:.4f} us a step, "
                  f"{100 * max(b_us, s_us) / times[n][0]:.1f} % of the "
                  f"bound; state {'exact' if agree[n][0] else 'NOT EXACT'}"
                  f", y {agree[n][1]:.2e} of row max)" for n in names))
        del sets


if __name__ == "__main__":
    main()
