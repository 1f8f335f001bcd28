#!/usr/bin/env python3
"""Time text variants of ``csrc/csd_matvec.cu``'s resident ``csd_qsweep``
route against the source as it stands and a float64 ``torch.matmul``, in
one process on one card.

    python3 experiments/csd_qsweep_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape Q,M,K,N,D] ...

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  Without ``--shape``, the sweep's three layers at
``chip_smoke.py``'s shapes: (4, 2248, 16|10) x (16|10, 16|10), D = 8.

Each variant is built with the package's nvcc flags, held bit for bit
against ``csd_qsweep_plain`` (printed, not asserted), and timed as
``chip_smoke.py`` times the CSD kernels (CUDA-graph replays over input
sets of at least twice the L2), in the order matmul, a, b, ..., b, a,
matmul.  Needs a CUDA card and nvcc; builds into
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
from repro_torch.kernels.csd_matvec import csd_qsweep_plain  # noqa: E402

SRC = (build.CSRC / "csd_matvec.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    "rows32": [("constexpr int kResRows = 64;", "constexpr int kResRows = 32;")],
    "rows128": [("constexpr int kResRows = 64;",
                 "constexpr int kResRows = 128;")],
    # y always staged in shared memory, then stored as one run
    "staged": [("const bool direct = N % 4 == 0 &&",
                "const bool direct = false &&")],
}

SHAPES = [(4, 2248, 16, 16, 8), (4, 2248, 16, 10, 8), (4, 2248, 10, 10, 8)]


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
        (vdir / f"cq_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"cq_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"cq_{name}")):
            if fn.startswith("csd_resident"):
                print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"cq_{name}")))
        f = lib.csd_qsweep_resident
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, x, planes):
        (Q, M, K), (D, N) = x.shape, planes.shape[1::2]
        out = torch.empty((Q, M, N), dtype=torch.int32, device="cuda")
        err = fns[name](x.data_ptr(), planes.data_ptr(), out.data_ptr(),
                        Q, M, K, N, D, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    rng = np.random.default_rng(0)
    order = list(variants) + list(variants)[::-1]
    for Q, M, K, N, D in shapes or SHAPES:
        x, planes = cs._csd_inputs(torch, rng, (Q, M, K), (K, N), D)
        want = csd_qsweep_plain(x, planes)
        exact = {n: bool(torch.equal(call(n, x, planes), want))
                 for n in variants}
        nbytes = Q * (M * K * 4 + planes.shape[1] * K * N + M * N * 4)
        sets = [cs._csd_inputs(torch, rng, (Q, M, K), (K, N), D)
                for _ in range(max(6, -(-2 * cs.L2_BYTES // nbytes)))]
        pw = (torch.arange(planes.shape[1], device="cuda",
                           dtype=torch.float64).exp2().reshape(-1, 1, 1))
        lib_sets = [(a.double(), (p.double() * pw).sum(dim=-3))
                    for a, p in sets]
        lib = [cs.time_calls(torch, torch.matmul, lib_sets, 20)[0] * 1e3]
        times = {n: [] for n in variants}
        for name in order:
            ms, _ = cs.time_calls(torch, lambda a, p, n=name: call(n, a, p),
                                  sets, 20)
            times[name].append(ms * 1e3)
        lib.append(cs.time_calls(torch, torch.matmul, lib_sets, 20)[0] * 1e3)
        print(f"({Q}, {M}, {K}) x ({K}, {N}), D = {planes.shape[1]} "
              f"[{cs.CARD}]: float64 matmul "
              f"{' / '.join(f'{v:.2f}' for v in lib)} us, " + ", ".join(
                  f"{n} {' / '.join(f'{v:.2f}' for v in ts)} us"
                  f"{'' if exact[n] else ' (NOT EXACT)'}"
                  for n, ts in times.items()))


if __name__ == "__main__":
    main()
