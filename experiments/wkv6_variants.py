#!/usr/bin/env python3
"""Time text variants of ``csrc/wkv6.cu`` against the source as it
stands, in one process on one card.

    python3 experiments/wkv6_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape B,S,H,hd] ...

``NAME=`` with no transform is the source itself.  A transform is a key
of ``EDITS``: ``lb0`` (``__launch_bounds__(HD)``, without the minimum
of one block a multiprocessor: the kernel's first version), ``acc4`` (out_j
summed in four partial sums, i mod 4, instead of one chain in i order;
y moves within the tolerance, the state stays exact), and ``noout``,
``noupd``, which give wrong results, to see what bounds a step: no
output sum, no state update.
So a variant differs from the source by its edits only.  ``--shape``
names the shapes (default: the rwkv6-3b loss (8, 1024, 40, 64), the
first ReferenceEngine prefill batch and a decode step (4, 1, 40, 64)).

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
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402

SRC = (build.CSRC / "wkv6.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    "lb0": [("__launch_bounds__(HD, 1)", "__launch_bounds__(HD)")],
    "acc4": [("float out = 0.0f;", "float acc[4] = {0.f, 0.f, 0.f, 0.f};"),
             ("out = fmaf(e.x, __fadd_rn(s[i], __fmul_rn(e.w, kv)), out);",
              "acc[i & 3] = fmaf(e.x, __fadd_rn(s[i], __fmul_rn(e.w, kv)), "
              "acc[i & 3]);"),
             ("y[here] = out;",
              "y[here] = (acc[0] + acc[1]) + (acc[2] + acc[3]);")],
    # wrong results, to see what bounds a step
    "noout": [("out = fmaf(e.x, __fadd_rn(s[i], __fmul_rn(e.w, kv)), out);",
               "")],
    "noupd": [("s[i] = __fadd_rn(__fmul_rn(e.z, s[i]), kv);", "")],
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
    specs, shapes, i = [], [], 0
    while i < len(args):
        if args[i] == "--shape":
            shapes.append(tuple(int(v) for v in args[i + 1].split(",")))
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
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, r, k, v, w, u, s0):
        y, sS = torch.empty_like(r), torch.empty_like(s0)
        err = fns[name](*(t.data_ptr() for t in (r, k, v, w, u, s0, y, sS)),
                        *r.shape[:3], r.shape[3],
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
        w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
        return (randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd),
                w, randn(H, hd) * 0.5, randn(B, H, hd, hd))

    names = list(variants)
    order = names + names[::-1]
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
        nbytes = cs.wkv_bytes(*shape)
        sets = [inputs(*shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        times = {n: [] for n in names}
        for n in order:
            ms, _ = cs.time_calls(torch, lambda *a, n=n: call(n, *a), sets,
                                  5)
            times[n].append(ms * 1e3)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e6
        print(f"{shape} [{cs.CARD}], bound {bound:.2f} us (bytes), "
              f"{len(sets)} input sets: " + ", ".join(
                  f"{n} {' / '.join(f'{v:.2f}' for v in times[n])} us "
                  f"({times[n][0] / shape[1]:.3f} us a step; state "
                  f"{'exact' if agree[n][0] else 'NOT EXACT'}, y "
                  f"{agree[n][1]:.2e} of row max)" for n in names))
        del sets


if __name__ == "__main__":
    main()
