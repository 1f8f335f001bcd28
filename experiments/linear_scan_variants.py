#!/usr/bin/env python3
"""Time the routes and text variants of ``csrc/linear_scan.cu`` against
the source as it stands, in one process on one card.

    python3 experiments/linear_scan_variants.py NAME=[TRANSFORM[+...]] ...
        [--route ROUTE] ... [--shape B,S,W] ... [--sweep]

``NAME=`` with no transform is the source itself.  A transform sets one
of the ring route's constants (``stages3``: ring depth, ``bt32``: steps a
stage, ``bw16``: channels a block, ``chunk8``: the steps a consumer's
loads run ahead) or is a key of ``EDITS``: ``regs`` (h stored from
registers, a row a step, instead of through shared memory as a TMA box),
and ``nostore`` and ``nowalk``, which give wrong results, to see what
bounds the walk.  So a variant differs from the source by its edits
only.  ``--route`` names the routes timed for each variant
(``linear_scan.ROUTES``; default ``ring``), ``--shape`` the shapes
(default: the hybrid's loss (1, 4096, 4096) and first prefill batch (4,
H_pre, 4096)).  ``--sweep`` instead times the step, ring and tiled
routes of each variant at (4, S, 4096) for S from 1 to 128: where the
step route stops paying (``linear_scan.STEP_MAX_S``).

Each variant is built with the package's nvcc flags, its ring kernel's
ptxas line printed, every (variant, route) held bit for bit against
``linear_scan_plain`` (printed, not asserted), and timed as
``chip_smoke.py`` times the scan (CUDA-graph replays over input sets of at
least twice the L2, the output allocated in each call), in the order a,
b, ..., b, a.  Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
"""
import ctypes
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.linear_scan import (ROUTES,  # noqa: E402
                                             linear_scan_plain)

SRC = (build.CSRC / "linear_scan.cu").read_text()

# the ring route's constants a variant may set: NAME<value> (``bt32``,
# ``stages3``, ``bw16``, ``chunk8``) sets the constant to the value
CONSTANTS = {"bt": "kRingBT", "stages": "kRingStages", "bw": "kRingBW",
             "chunk": "kRingChunk"}
# name -> [(old text, new text), ...]
EDITS = {
    "regs": [("kStagedStore = true;", "kStagedStore = false;")],
    # wrong results, to see what bounds the walk: h stored once a tile; no
    # walk at all (the ring's copies alone)
    "nostore": [("if (lane < kRingBW) os[", "if (r0 + j == 0) os[")],
    "nowalk": [("for (int r0 = 0; r0 < steps;", "for (int r0 = 0; r0 < 0;")],
}


def edits(t):
    m = re.fullmatch(r"([a-z]+)(\d+)", t)
    if m and m.group(1) in CONSTANTS:
        name = CONSTANTS[m.group(1)]
        old = re.search(rf"{name} = \d+;", SRC).group(0)
        return [(old, f"{name} = {m.group(2)};")]
    return EDITS[t]


def variant(transforms):
    src = SRC
    for t in transforms:
        for a, b in edits(t):
            if a not in src:
                raise ValueError(f"{t}: the source no longer holds {a!r}")
            src = src.replace(a, b)
    return src


def main():
    args = sys.argv[1:]
    opts = {"--route": [], "--shape": []}
    specs, sweep, i = [], False, 0
    while i < len(args):
        if args[i] in opts:
            opts[args[i]].append(args[i + 1])
            i += 2
            continue
        if args[i] == "--sweep":
            sweep = True
        else:
            specs.append(args[i])
        i += 1
    routes = opts["--route"] or ["ring"]
    for r in routes:
        if r not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, not {r!r}")
    if sweep:
        routes = ["step", "ring", "tiled"]
        shapes = [(4, s, 4096) for s in (1, 2, 4, 8, 16, 32, 64, 128)]
    else:
        shapes = ([tuple(int(v) for v in s.split(",")) for s in opts["--shape"]]
                  or [(1, cs.HYB_LOSS_SEQ, 4096),
                      (cs.HYB_BATCH, cs.hybrid_prefill_len(), 4096)])
    variants = {}
    for spec in specs or ["a="]:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"ls_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"ls_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"ls_{name}")):
            if fn.startswith("linear_scan_ring"):
                print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"ls_{name}")))
        f = lib.linear_scan
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, route, a, x):
        out = torch.empty_like(a)
        B, S, W = a.shape
        err = fns[name](a.data_ptr(), x.data_ptr(), out.data_ptr(), B, S, W,
                        ROUTES.index(route),
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}:{route}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.3 + 0.7
        x = torch.randn(shape, generator=gen, device="cuda") * 0.1
        return a, x

    keys = [(n, r) for n in variants for r in routes]
    order = keys + keys[::-1]
    for shape in shapes:
        a, x = inputs(shape)
        want = linear_scan_plain(a, x).view(torch.int32)
        exact = {k: bool(torch.equal(call(*k, a, x).view(torch.int32), want))
                 for k in keys}
        nbytes = 3 * 4 * a.numel()
        sets = [inputs(shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        times = {k: [] for k in keys}
        eager = {k: [] for k in keys}
        for k in order:
            ms, eager_ms = cs.time_calls(
                torch, lambda a, x, k=k: call(*k, a, x), sets, 5)
            times[k].append(ms * 1e3)
            eager[k].append(eager_ms * 1e3)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e6
        print(f"{shape} [{cs.CARD}], bound {bound:.3f} us, {len(sets)} input "
              f"sets: " + ", ".join(
                  f"{n}:{r} {' / '.join(f'{v:.2f}' for v in times[n, r])} us"
                  f" (eager {' / '.join(f'{v:.2f}' for v in eager[n, r])})"
                  f"{'' if exact[n, r] else ' (NOT EXACT)'}"
                  for n, r in keys))
        del sets


if __name__ == "__main__":
    main()
