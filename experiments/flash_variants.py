#!/usr/bin/env python3
"""Time text variants of ``csrc/flash_attention.cu``'s bf16 route against
the source as it stands, in one process on one card.

    python3 experiments/flash_variants.py [--d64] NAME=[TRANSFORM[+...]] ...

``NAME=`` with no transform is the source itself.  Transforms (each a
text edit of the source, so a variant differs from it by that edit only):

    exp2f     exp2f (2 ulp, subnormals kept) in place of ex2.approx.ftz
    twocta    __launch_bounds__ asking for two blocks an SM at D <= 64
    st3       a K/V ring of 3 stages (D = 64 only: at D = 256 it does not
              fit in shared memory)
    noload    no K/V copy after the first two tiles (wrong results: shows
              what the loads cost)
    wg1       one warpgroup of 64 rows a block, four blocks an SM at D = 64
    pingpong  the two warpgroups take turns (named barriers) to issue
              their products, so one's softmax overlaps the other's
    pack      the G query heads of a KV head packed into a warpgroup's
              rows (PW = 64 // G positions x G heads), K/V read once a block

Each variant is built with the package's nvcc flags, held against
``flash_attention_plain`` at ``KEY_TILE`` under ``bf16_disagreement``
(printed, not asserted: ``noload`` computes on stale tiles), and timed as
``chip_smoke.py`` times the flash row (CUDA-graph replays over input sets
of at least twice the L2), in the order a, b, ..., b, a, at the qwen2-0.5b
loss and first prefill batch shapes and (without ``--d64``) the
recurrentgemma-9b loss and first prefill batch shapes.  Needs a CUDA card
and nvcc; builds into ``src/repro_torch/kernels/_build/``.
"""
import ctypes
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KEY_TILE, bf16_disagreement, flash_attention_plain)

SRC = (build.CSRC / "flash_attention.cu").read_text()

PINGPONG_HELPERS = '''
// the two warpgroups take turns to issue their products (barrier 3: the
// first's turn, 4: the second's), so one's softmax overlaps the other's
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kWG'''


def pingpong(src):
    """Both products of a tile issued in turns; every tile takes its two
    turns, computed or skipped, and the arrivals balance at the end."""
    a = src.index("    if (kv0 < mine.hi && kv0 + KT > mine.lo) {")
    b = src.index("    mbar_arrive(&empty[s]);\n  }\n  if (!live) return;")
    body = src[a:b]
    qk_end = ("      wgmma_commit();\n      wgmma_wait_all();\n"
              "      pin<KT / 2>(sc);")
    pv_end = ("      wgmma_commit();\n      wgmma_wait_all();\n#pragma unroll\n"
              "      for (int c = 0; c < SLABS; ++c) pin<DW / 2>(o[c]);")
    i_qk, i_pv = body.index(qk_end), body.index("      // O += P V, V MN-major")
    head = body[:i_qk].replace(
        "    if (kv0 < mine.hi && kv0 + KT > mine.lo) {\n",
        "    const bool work = kv0 < mine.hi && kv0 + KT > mine.lo;\n"
        "    float sc[KT / 2];\n    uint32_t pa[KT / 16][4];\n"
        "    turn_wait(3 + wg);\n    if (work) {\n").replace(
        "      float sc[KT / 2];\n", "")
    softmax = body[i_qk + len(qk_end):i_pv].replace(
        "      uint32_t pa[KT / 16][4];\n", "")
    pv = body[i_pv:body.index(pv_end)]
    new = (head + "      wgmma_commit();\n    }\n    turn_pass(4 - wg);\n"
           "    if (work) {\n      wgmma_wait_all();\n      pin<KT / 2>(sc);"
           + softmax + "    }\n    turn_wait(3 + wg);\n    if (work) {\n"
           "      const uint32_t v_addr =\n"
           "          smem_u32(kv_s + s * 2 * T::KV_BYTES) + T::KV_BYTES;\n"
           + pv + "      wgmma_commit();\n    }\n"
           "    if (wg == 0 || it + 1 < n_tiles) turn_pass(4 - wg);\n"
           "    if (work) {\n      wgmma_wait_all();\n#pragma unroll\n"
           "      for (int c = 0; c < SLABS; ++c) pin<DW / 2>(o[c]);\n    }\n")
    src = src[:a] + new + src[b:]
    src = src.replace("\ntemplate <int D>\n__global__ void __launch_bounds__(kWG",
                      PINGPONG_HELPERS, 1)
    return src.replace("  mbar_wait(q_bar, 0);\n",
                       "  mbar_wait(q_bar, 0);\n  if (wg == 1) turn_pass(3);\n", 1)


PACK = [
    ("""                             const __grid_constant__ CUtensorMap to, int Sq,
                             int Hq, int Hkv, int kv_len, int offset,""",
     """                             const __grid_constant__ CUtensorMap to, int Sq,
                             int G, int GH, int kv_len, int offset,"""),
    ("""  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int hk = h / (Hq / Hkv);""",
     """  const int PW = 64 / GH;
  const int h0 = blockIdx.x * GH;
  const int hk = h0 / G;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWG * PW;"""),
    ("need(q0, min(q0 + kRows, Sq) - 1,", "need(q0, min(q0 + kWG * PW, Sq) - 1,"),
    ("  const int w0 = q0 + 64 * wg;", "  const int w0 = q0 + PW * wg;"),
    ("need(w0, min(w0 + 64, Sq) - 1,", "need(w0, min(w0 + PW, Sq) - 1,"),
    ("""  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {""",
     """  for (int i = tid; i < kWG * SLABS * (64 - PW * GH) * W / 16; i += kWG * 128) {
    const int row = PW * GH + i / (W / 16) % (64 - PW * GH);
    const int slab = i / (W / 16) / (64 - PW * GH);
    *reinterpret_cast<uint4*>(q_s + slab * 64 * W + row * W +
                              i % (W / 16) * 16) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {"""),
    ("    mbar_expect_tx(q_bar, kWG * T::Q_BYTES);",
     "    mbar_expect_tx(q_bar, kWG * PW * GH * D * 2);"),
    ("""        tma_load(q_s + w * T::Q_BYTES + c * 64 * W, &tq, q_bar, c * DW, h,
                 q0 + 64 * w, b);""",
     """        tma_load(q_s + w * T::Q_BYTES + c * 64 * W, &tq, q_bar, c * DW, h0,
                 q0 + PW * w, b);"""),
    ("  const int r_a = w0 + 16 * warp + lane / 4;",
     "  const int r_a = 16 * warp + lane / 4;\n"
     "  const int qp2[2] = {w0 + r_a / GH + offset, w0 + (r_a + 8) / GH + offset};"),
    ("          const int qp = r_a + 8 * ((i >> 1) & 1) + offset;",
     "          const int qp = qp2[(i >> 1) & 1];"),
    ("      const int row = 16 * warp + lane / 4 + 8 * rr;",
     "      const int row = r_a + 8 * rr;"),
    ("      tma_store(&to, o_s + c * 64 * W, c * DW, h, w0, b);",
     "      tma_store(&to, o_s + c * 64 * W, c * DW, h0, w0, b);"),
    ("""                int S, int H, int rows) {""",
     """                int S, int H, int heads, int rows) {"""),
    ("  const cuuint32_t box[4] = {(cuuint32_t)T::DW, 1, (cuuint32_t)rows, 1};",
     "  const cuuint32_t box[4] = {(cuuint32_t)T::DW, (cuuint32_t)heads,\n"
     "                             (cuuint32_t)rows, 1};"),
    ("""  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<D>(enc, &tq, q, B, Sq, Hq, 64) ||
      !tensor_map<D>(enc, &tk, k, B, Skv, Hkv, T::KT) ||
      !tensor_map<D>(enc, &tv, v, B, Skv, Hkv, T::KT) ||
      !tensor_map<D>(enc, &to, out, B, Sq, Hq, 64))""",
     """  const int G = Hq / Hkv;
  int GH = G < 64 ? G : 64;
  while (G % GH) --GH;
  const int PW = 64 / GH;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<D>(enc, &tq, q, B, Sq, Hq, GH, PW) ||
      !tensor_map<D>(enc, &tk, k, B, Skv, Hkv, 1, T::KT) ||
      !tensor_map<D>(enc, &tv, v, B, Skv, Hkv, 1, T::KT) ||
      !tensor_map<D>(enc, &to, out, B, Sq, Hq, GH, PW))"""),
    ("""  const dim3 grid(Hq, B, (Sq + kRows - 1) / kRows);""",
     """  const dim3 grid(Hq / GH, B, (Sq + kWG * PW - 1) / (kWG * PW));"""),
    ("""      tq, tk, tv, to, Sq, Hq, Hkv, kv_len, offset, causal, window, kv_pad,""",
     """      tq, tk, tv, to, Sq, G, GH, kv_len, offset, causal, window, kv_pad,"""),
]

EDITS = {
    "exp2f": [("ex2(m[rr] - m_new)", "exp2f(m[rr] - m_new)"),
              ("ex2(sc[i] - m[rr])", "exp2f(sc[i] - m[rr])")],
    "twocta": [("__launch_bounds__(kWG * 128, 1)",
                "__launch_bounds__(kWG * 128, D <= 64 ? 2 : 1)")],
    "st3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "noload": [("""    mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
#pragma unroll""", """    mbar_expect_tx(&full[s], u < kStages ? 2 * T::KV_BYTES : 0);
    if (u >= kStages) return;
#pragma unroll""")],
    "wg1": [("constexpr int kWG = 2;", "constexpr int kWG = 1;"),
            ("__launch_bounds__(kWG * 128, 1)",
             "__launch_bounds__(kWG * 128, D <= 64 ? 4 : 1)")],
    "pack": PACK,
}


def variant(transforms):
    src = SRC
    for t in transforms:
        if t == "pingpong":
            src = pingpong(src)
            continue
        for a, b in EDITS[t]:
            if a not in src:
                raise ValueError(f"{t}: the source no longer holds {a!r}")
            src = src.replace(a, b)
    return src


def main():
    d64 = "--d64" in sys.argv
    specs = [a for a in sys.argv[1:] if a != "--d64"]
    variants = {}
    for spec in specs:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"fa_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"fa_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    fns = {}
    for name in variants:
        for fn, line in cs.ptxas_lines(build.build_log(f"fa_{name}")):
            if fn in ("flash_attention_wgmma_kernelILi64EE",
                      "flash_attention_wgmma_kernelILi256EE"):
                print(f"  {name} {fn}: {line}")
        lib = ctypes.CDLL(str(build.library_path(f"fa_{name}")))
        f = lib.flash_attention
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, q, k, v, window, bk):
        B, Sq, Hq, D = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None, B, Sq, Skv, Hq, Hkv, D, Skv,
                        0, 1,
                        window, -(-Skv // bk) * bk, 1.0 / math.sqrt(D), 1,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out

    cs.CARD = cs.card_line()
    print(cs.CARD)
    gen = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.launch import serve_quantized as sq
    s_pre = max(len(p) for p in sq.prompts(151936)[:sq.MAX_BATCH])
    h_pre = cs.hybrid_prefill_len()
    shapes = [("loss", (8, 1024, 1024, 14, 2, 64), 0),
              (f"prefill S={s_pre}", (8, s_pre, s_pre, 14, 2, 64), 0),
              ("hybrid loss", (1, 4096, 4096, 16, 1, 256), 2048),
              (f"hybrid prefill S={h_pre}", (cs.HYB_BATCH, h_pre, h_pre, 16,
                                             1, 256), 2048)]
    order = list(variants) + list(variants)[::-1]
    for label, (B, Sq, Skv, Hq, Hkv, D), window in shapes:
        if d64 and D != 64:
            continue

        def qkv():
            return [torch.randn(s, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                    for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                              (B, Skv, Hkv, D))]
        q, k, v = qkv()
        want = flash_attention_plain(q, k, v, causal=True, window=window,
                                     offset=0, bk=KEY_TILE)
        for name in variants:
            ratio, share = bf16_disagreement(call(name, q, k, v, window, 512),
                                             want)
            print(f"{label} {name}: err / limit {ratio:.3f}, share "
                  f"{share:.3e}")
        one = 2 * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
        sets = [qkv() for _ in range(max(2, -(-2 * cs.L2_BYTES // one)))]
        times = {n: [] for n in variants}
        for name in order:
            ms, _ = cs.time_calls(torch, lambda q, k, v, n=name: call(
                n, q, k, v, window, 512), sets, 5)
            times[name].append(ms * 1e3)
        print(f"{label} [{cs.CARD}]: " + ", ".join(
            f"{n} {' / '.join(f'{t:.2f}' for t in ts)} us"
            for n, ts in times.items()))


if __name__ == "__main__":
    main()
