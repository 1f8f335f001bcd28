#!/usr/bin/env python3
"""Time text variants of ``csrc/paged_gather.cu`` against the source as it
stands, two one-leaf launches and ``index_select``, in one process on one
card.

    python3 experiments/paged_gather_variants.py NAME=[TRANSFORM[+...]] ...
        [--shape NB,BS,H,D,P,NBLK]

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  Without ``--shape``, one prefill dispatch's gather in
``chip_smoke.py``'s serving cell: pools (256, 32, 2, 64) bf16, one K and
one V pool a layer for 24 layers, and the (4, 32) int64 table the model
hoists once a dispatch, sentinel entries included.

Each variant is built with the package's nvcc flags, held bit for bit
against ``paged_gather_plain`` (printed, not asserted), and timed as
``chip_smoke.py`` times the kernels (CUDA-graph replays cycling over every
layer's pools, together larger than the L2), in the order a, b, ..., b,
a: the pair (K and V in one launch) on the bulk route and on the vector
route, then the one-leaf kernel twice a layer, beside ``index_select``
twice a layer.  Needs a CUDA card and nvcc;
builds into ``src/repro_torch/kernels/_build/``.
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
from repro_torch.kernels.paged_gather import paged_gather_plain  # noqa: E402

SRC = (build.CSRC / "paged_gather.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    "nopdl": [("constexpr bool kPdl = true;", "constexpr bool kPdl = false;")],
    # the table read before griddepcontrol.wait: overlaps the kernel before,
    # but races a table that kernel writes
    "early": [("  wait_for_producer();\n  const long long phys = block_id(",
               "  const long long phys = block_id("),
              ("  asm volatile(\"mbarrier.arrive",
               "  wait_for_producer();\n  asm volatile(\"mbarrier.arrive"),
              ("  V r[kVecUnroll];",
               "  wait_for_producer();\n  V r[kVecUnroll];")],
    "u2": [("constexpr int kVecUnroll = 4;", "constexpr int kVecUnroll = 2;")],
    "u8": [("constexpr int kVecUnroll = 4;", "constexpr int kVecUnroll = 8;")],
    "chunk4k": [("constexpr int kChunk = 16384;",
                 "constexpr int kChunk = 4096;")],
    "chunk2k": [("constexpr int kChunk = 16384;",
                 "constexpr int kChunk = 2048;")],
}

L = 24
SHAPE = (256, 32, 2, 64, 4, 32)


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
    shape = SHAPE
    if "--shape" in args:
        i = args.index("--shape")
        shape = tuple(int(v) for v in args[i + 1].split(","))
        del args[i:i + 2]
    variants = {}
    for spec in args:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"pg_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"pg_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"pg_{name}")):
            print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"pg_{name}")))
        one, pair = lib.paged_gather, lib.paged_gather_pair
        one.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        pair.argtypes = [ctypes.c_void_p] * 5 + one.argtypes[3:]
        one.restype = pair.restype = ctypes.c_int
        fns[name] = (one, pair)

    NB, bs, H, D, P, nb = shape
    block_bytes = bs * H * D * 2

    def call_pair(name, k, v, t, route=0):
        ko = torch.empty((P, nb, bs, H, D), dtype=k.dtype, device="cuda")
        vo = torch.empty_like(ko)
        err = fns[name][1](k.data_ptr(), v.data_ptr(), t.data_ptr(),
                           ko.data_ptr(), vo.data_ptr(), P * nb, NB,
                           block_bytes, 1, route,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return ko, vo

    def call_one(name, leaf, t):
        out = torch.empty((P, nb, bs, H, D), dtype=leaf.dtype, device="cuda")
        err = fns[name][0](leaf.data_ptr(), t.data_ptr(), out.data_ptr(),
                           P * nb, NB, block_bytes, 1, 0,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kpool, vpool = (torch.randn((L, NB, bs, H, D), generator=gen,
                                device="cuda", dtype=torch.bfloat16)
                    for _ in range(2))
    tbl = rng.permutation(NB)[:P * nb].reshape(P, nb).astype(np.int64)
    for p in range(P):
        tbl[p, (p + 1) * nb // (P + 1):] = NB          # not granted yet
    t = torch.from_numpy(tbl).cuda()
    tc = torch.clamp(t, max=NB - 1)
    flat = tc.reshape(-1)
    want = [paged_gather_plain(pool[0], tc) for pool in (kpool, vpool)]
    exact = {}
    for n in variants:
        exact[n] = torch.equal(call_one(n, vpool[0], t), want[1])
        for route in (0, 1):
            k, v = call_pair(n, kpool[0], vpool[0], t, route)
            exact[n] &= torch.equal(k, want[0]) and torch.equal(v, want[1])
    sets = [(kpool[i], vpool[i], t) for i in range(L)]
    order = list(variants) + list(variants)[::-1]
    lib = [cs.time_calls(torch, lambda k, v, _: (k.index_select(0, flat),
                                                  v.index_select(0, flat)),
                         sets, 20)[0] * 1e3]
    pair_t = {n: [] for n in variants}
    vec_t = {n: [] for n in variants}
    one_t = {n: [] for n in variants}
    for name in order:
        ms, _ = cs.time_calls(
            torch, lambda k, v, tt, n=name: call_pair(n, k, v, tt), sets, 20)
        pair_t[name].append(ms * 1e3)
        ms, _ = cs.time_calls(
            torch, lambda k, v, tt, n=name: call_pair(n, k, v, tt, 1), sets,
            20)
        vec_t[name].append(ms * 1e3)
        ms, _ = cs.time_calls(
            torch, lambda k, v, tt, n=name: (call_one(n, k, tt),
                                             call_one(n, v, tt)), sets, 20)
        one_t[name].append(ms * 1e3)
    lib.append(cs.time_calls(torch, lambda k, v, _: (
        k.index_select(0, flat), v.index_select(0, flat)), sets, 20)[0] * 1e3)
    uniq = int(torch.unique(tc).numel())
    nbytes = 2 * (uniq * block_bytes + P * nb * block_bytes) + P * nb * 8
    print(f"pools ({NB}, {bs}, {H}, {D}) bf16 x {L} layers, table ({P}, "
          f"{nb}) int64 [{cs.CARD}]: bound of a pair "
          f"{nbytes / cs.HBM_BYTES_PER_S * 1e6:.3f} us; index_select x 2 "
          f"{' / '.join(f'{v:.2f}' for v in lib)} us")
    for n in variants:
        print(f"  {n}: pair {' / '.join(f'{v:.2f}' for v in pair_t[n])} us, "
              f"on the vector route "
              f"{' / '.join(f'{v:.2f}' for v in vec_t[n])} us, "
              f"two one-leaf launches "
              f"{' / '.join(f'{v:.2f}' for v in one_t[n])} us"
              f"{'' if exact[n] else ' (NOT EXACT)'}")


if __name__ == "__main__":
    main()
