#!/usr/bin/env python3
"""Time text variants and tilings of ``csrc/qmatmul.cu``'s TMA route
against the source as it stands, in one process on one card.

    python3 experiments/qmatmul_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape M,K,N[:BM:SPLIT]] ...

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  ``--shape`` picks a shape and, optionally, an M tile
and a split of K in place of ``qmatmul.tiling``'s (the split is evened
out as the rule evens it); without ``--shape``, the ten widths
``chip_smoke.py`` times at M = 8 and 512, each at the rule's tiling.

Each variant is built with the package's nvcc flags, held bit for bit
against ``qmatmul_plain`` (printed, not asserted), and timed as
``chip_smoke.py`` times the qmatmul rows (CUDA-graph replays over input
sets of at least twice the L2, the workspace and zeroed counters
allocated in each call as the wrapper allocates them), in the order a,
b, ..., b, a.  Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
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
from repro_torch.kernels.qmatmul import (  # noqa: E402
    CHANNELS, K_TILE, qmatmul_plain, tiling)

SRC = (build.CSRC / "qmatmul.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    # a stage's A fragments built and issued in two halves of two k32
    # steps, each waited for (16 A registers live, not 32)
    "half": [("    uint32_t a[kBK / 32][2][4];\n#pragma unroll\n"
              "    for (int kk = 0; kk < kBK / 32; ++kk) {",
              "#pragma unroll\n    for (int h = 0; h < kBK / 32; h += 2) {\n"
              "    uint32_t a[kBK / 32][2][4];\n#pragma unroll\n"
              "    for (int kk = h; kk < h + 2; ++kk) {"),
             ("    for (int kk = 0; kk < kBK / 32; ++kk) {\n"
              "      const uint64_t b",
              "    for (int kk = h; kk < h + 2; ++kk) {\n"
              "      const uint64_t b"),
             ("    pin<BM / 2>(acc[1]);\n    mbar_arrive(&empty[s]);",
              "    pin<BM / 2>(acc[1]);\n    }\n    mbar_arrive(&empty[s]);")],
    # the last split of a tile adds no other slice (wrong results: shows
    # what the reduction costs)
    "noreduce": [("    for (int z0 = 0; z0 < split; z0 += ZB) {",
                  "    for (int z0 = 0; z0 < 0; z0 += ZB) {")],
}

WIDTHS = [(M, K, N) for M in (8, 512)
          for K, N in [(896, 151936), (896, 896), (896, 128), (896, 4864),
                       (4864, 896)]]


def variant(transforms):
    src = SRC
    for t in transforms:
        for a, b in EDITS[t]:
            if a not in src:
                raise ValueError(f"{t}: the source no longer holds {a!r}")
            src = src.replace(a, b)
    return src


def parse_shape(spec):
    """'M,K,N[:BM:SPLIT]' -> ((M, K, N), (bm, split, kt_per))."""
    dims, *tile = spec.split(":")
    M, K, N = (int(v) for v in dims.split(","))
    if not tile:
        return (M, K, N), tuple(tiling(M, K, N))
    bm, split = int(tile[0]), int(tile[1])
    n_k = -(-K // K_TILE)
    kt_per = -(-n_k // split)
    return (M, K, N), (bm, -(-n_k // kt_per), kt_per)


def main():
    args = sys.argv[1:]
    shapes = [parse_shape(args[i + 1]) for i, a in enumerate(args)
              if a == "--shape"]
    specs = [a for i, a in enumerate(args)
             if a != "--shape" and (i == 0 or args[i - 1] != "--shape")]
    shapes = shapes or [parse_shape(",".join(map(str, s))) for s in WIDTHS]
    variants = {}
    for spec in specs:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"qm_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"qm_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"qm_{name}")):
            if fn.startswith("qmatmul_tma_kernel") and "Ef" in fn:
                print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"qm_{name}")))
        f = lib.qmatmul_tma
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, t, x, w, e):
        (M, K), N = x.shape, w.shape[1]
        bm, split, kt_per = t
        out = torch.empty((M, N), dtype=torch.float32, device="cuda")
        ws = counts = None
        if split > 1:
            ws = torch.empty((split, M, N), dtype=torch.int32, device="cuda")
            counts = torch.zeros(-(-M // bm) * -(-N // CHANNELS),
                                 dtype=torch.int32, device="cuda")
        err = fns[name](x.data_ptr(), w.data_ptr(), e.data_ptr(),
                        out.data_ptr(),
                        None if ws is None else ws.data_ptr(),
                        None if counts is None else counts.data_ptr(),
                        M, N, K, 0, bm, split, kt_per,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(variants) + list(variants)[::-1]
    for (M, K, N), t in shapes:
        def inputs():
            return (torch.randint(-128, 128, (M, K), generator=gen,
                                  device="cuda", dtype=torch.int8),
                    torch.randint(-128, 128, (K, N), generator=gen,
                                  device="cuda", dtype=torch.int8),
                    torch.randint(-20, 21, (N,), generator=gen,
                                  device="cuda", dtype=torch.int32))
        x, w, e = inputs()
        want = qmatmul_plain(x, w, e)
        exact = {n: bool(torch.equal(call(n, t, x, w, e), want))
                 for n in variants}
        one = M * K + K * N + 4 * N + 4 * M * N
        sets = [inputs() for _ in range(max(2, -(-2 * cs.L2_BYTES // one)))]
        times = {n: [] for n in variants}
        for name in order:
            ms, _ = cs.time_calls(torch, lambda x, w, e, n=name: call(
                n, t, x, w, e), sets, 5)
            times[name].append(ms * 1e3)
        print(f"{(M, K, N)} bm {t[0]} split {t[1]} kt_per {t[2]} "
              f"[{cs.CARD}]: " + ", ".join(
                  f"{n} {' / '.join(f'{v:.2f}' for v in ts)} us"
                  f"{'' if exact[n] else ' (NOT EXACT)'}"
                  for n, ts in times.items()))


if __name__ == "__main__":
    main()
