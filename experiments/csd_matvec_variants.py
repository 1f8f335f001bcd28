#!/usr/bin/env python3
"""Time text variants of ``csrc/csd_matvec.cu``'s streaming ``csd_matvec``
route against the source as it stands, its ``planes`` route, the resident
``csd_qsweep`` route at Q = 1 and a float64 ``torch.matmul``, in one
process on one card.

    python3 experiments/csd_matvec_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape M,K,N,D] ...

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  Without ``--shape``, one polish call's dense tail at
``chip_smoke.py``'s shape: (287744, 10) x (8, 10, 10).

Each variant is built with the package's nvcc flags, held bit for bit
against ``csd_matvec_plain`` (printed, not asserted), and timed as
``chip_smoke.py`` times the CSD kernels (CUDA-graph replays over input
sets of at least twice the L2), in the order matmul, a, b, ..., b, a,
matmul; the first variant's planes and resident routes are timed once.
Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
"""
import ctypes
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
from repro_torch.kernels.csd_matvec import csd_matvec_plain  # noqa: E402

SRC = (build.CSRC / "csd_matvec.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    "stages2": [("constexpr int kStreamStages = 3;",
                 "constexpr int kStreamStages = 2;")],
    "stages4": [("constexpr int kStreamStages = 3;",
                 "constexpr int kStreamStages = 4;")],
    "stages6": [("constexpr int kStreamStages = 3;",
                 "constexpr int kStreamStages = 6;")],
    "bps2": [("constexpr int kStreamBlocksPerSm = 4;",
              "constexpr int kStreamBlocksPerSm = 2;")],
    "bps8": [("constexpr int kStreamBlocksPerSm = 4;",
              "constexpr int kStreamBlocksPerSm = 8;")],
    "bps16": [("constexpr int kStreamBlocksPerSm = 4;",
               "constexpr int kStreamBlocksPerSm = 16;")],
    "rows64": [("constexpr int kStreamThreads = 128;",
                "constexpr int kStreamThreads = 64;"),
               ("constexpr int kStreamRows = 128;",
                "constexpr int kStreamRows = 64;")],
    "rows256": [("constexpr int kStreamThreads = 128;",
                 "constexpr int kStreamThreads = 256;"),
                ("constexpr int kStreamRows = 128;",
                 "constexpr int kStreamRows = 256;")],
    # any N: the column-group loop outside k (x read again a group)
    "generic": [("  const int NG = (N + 3) / 4;\n  // the paper's layers",
                 "  const int NG = 0;\n  // the paper's layers")],
    # only k = 0 of each row (not exact): the floor of copies and stores
    "k1": [("          for (int k = 0; k < K; ++k) add(xr[k], k);",
            "          for (int k = 0; k < 1; ++k) add(xr[k], k);")],
    # x read one word at a time at every K
    "scalarx": [("        if (K % 4 == 0 && lead == 0) {",
                 "        if (false) {")],
    # y staged one word at a time at every N
    "scalary": [("          if (N % 4 == 0) {", "          if (false) {")],
    # K a runtime value at every shape (the k loop not unrolled)
    "runk": [("K == 10   ?", "K == -10  ?"), ("K == 16 ?", "K == -16 ?")],
}

SHAPES = [(287744, 10, 10, 8)]


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
    shapes = [tuple(int(v) for v in args[i + 1].split(","))
              for i, a in enumerate(args) if a == "--shape"]
    specs = [a for i, a in enumerate(args)
             if a != "--shape" and (i == 0 or args[i - 1] != "--shape")]
    variants = {}
    for spec in specs:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"cm_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"cm_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"cm_{name}")):
            if fn.startswith("csd_stream"):
                print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"cm_{name}")))
        f = lib.csd_matvec
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        r = lib.csd_qsweep_resident
        r.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = r.restype = ctypes.c_int
        fns[name] = (f, r)

    def call(name, x, planes, how=0):
        (M, K), (D, N) = x.shape, planes.shape[::2]
        out = torch.empty((M, N), dtype=torch.int32, device="cuda")
        s = torch.cuda.current_stream().cuda_stream
        if how == 2:
            err = fns[name][1](x.data_ptr(), planes.data_ptr(),
                               out.data_ptr(), 1, M, K, N, D, s)
        else:
            err = fns[name][0](x.data_ptr(), planes.data_ptr(),
                               out.data_ptr(), M, K, N, D, how, s)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    rng = np.random.default_rng(0)
    first = list(variants)[0]
    order = list(variants) + list(variants)[::-1]
    for M, K, N, D in shapes or SHAPES:
        x, planes = cs._csd_inputs(torch, rng, (M, K), (K, N), D)
        want = csd_matvec_plain(x, planes)
        exact = {n: bool(torch.equal(call(n, x, planes), want))
                 for n in variants}
        others = {"planes": 1, "resident": 2}
        exact.update({r: bool(torch.equal(call(first, x, planes, h), want))
                      for r, h in others.items()})
        nbytes = M * K * 4 + D * K * N + M * N * 4
        sets = [cs._csd_inputs(torch, rng, (M, K), (K, N), D)
                for _ in range(max(6, -(-2 * cs.L2_BYTES // nbytes)))]
        pw = (torch.arange(D, device="cuda", dtype=torch.float64).exp2()
              .reshape(-1, 1, 1))
        lib_sets = [(a.double(), (p.double() * pw).sum(dim=0))
                    for a, p in sets]
        lib = [cs.time_calls(torch, torch.matmul, lib_sets, 20)[0] * 1e3]
        times = {n: [] for n in variants}
        for name in order:
            ms, _ = cs.time_calls(torch, lambda a, p, n=name: call(n, a, p),
                                  sets, 20)
            times[name].append(ms * 1e3)
        routes = {r: cs.time_calls(torch, lambda a, p, h=h: call(
            first, a, p, h), sets, 20)[0] * 1e3 for r, h in others.items()}
        lib.append(cs.time_calls(torch, torch.matmul, lib_sets, 20)[0] * 1e3)
        print(f"({M}, {K}) x ({D}, {K}, {N}) [{cs.CARD}]: bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e6:.2f} us; float64 matmul "
              f"{' / '.join(f'{v:.2f}' for v in lib)} us, " + ", ".join(
                  f"{n} {' / '.join(f'{v:.2f}' for v in ts)} us"
                  f"{'' if exact[n] else ' (NOT EXACT)'}"
                  for n, ts in times.items()) + "; " + ", ".join(
                  f"{r} route ({first}) {v:.2f} us"
                  f"{'' if exact[r] else ' (NOT EXACT)'}"
                  for r, v in routes.items()))


if __name__ == "__main__":
    main()
