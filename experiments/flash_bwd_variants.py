#!/usr/bin/env python3
"""Time text variants of ``csrc/flash_attention_bwd.cu``'s bf16 kernels
against the source as it stands, in one process on one card.

    python3 experiments/flash_bwd_variants.py NAME=[TRANSFORM[+...]] ...

``NAME=`` with no transform is the source itself; ``NAME=@FILE`` takes
the source from FILE (another version of the file, same C interface).
Transforms (each a text edit of the source, so a variant differs from it
by that edit only):

    cN        the dK/dV kernel on clusters of min(N, G) blocks (c1: each
              block walks all G heads; not a text edit: the launch's
              cluster argument)
    nolse     the producer copies no lse / delta (wrong results: shows what
              the copies cost)
    lepi      the cluster sum by remote loads from each block's own shared
              memory, all c loads issued before the sum, 3 cluster barriers
    dq3       the dQ kernel three blocks an SM at D <= 64 (136 registers)
    tinyepi   one sum a warp stored in place of the cluster sum (wrong)
    nostart   a ~2 us spin before the first loads (shows start-up cost)
    nw2       two consumer warpgroups a block at D = 64 too (one block an
              SM), sharing each stage's tiles

Each variant is built with the package's nvcc flags (its ptxas report and
the highest register its SASS names are printed), held against the
package's own kernels (largest |difference| printed, not asserted), and
its dK/dV and dQ launches timed alone with CUDA events (20 launches after
3 untimed), in the order a, b, ..., b, a, at qwen2-0.5b's loss shape (8,
1024, 14 / 2, 64), the same heads as MHA (14 / 14) and D = 128 GQA 8:1
(8, 1024, 16 / 2, 128), bf16, causal (``NONCAUSAL=1`` adds the two D =
64 shapes without a mask), each line naming the cluster size the
wrapper's ``bwd_cluster`` picks there.  ``SASS_DIR=DIR`` writes each
variant's SASS (``cuobjdump -sass``) into DIR.  Needs a CUDA card and
nvcc.
"""
import ctypes
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _bwd_entry, bwd_cluster, flash_attention_kernel)

SRC = (build.CSRC / "flash_attention_bwd.cu").read_text()
OUT = build.BUILD_DIR / "variants"
SHAPES = [(8, 1024, 14, 2, 64, 1), (8, 1024, 14, 14, 64, 1),
          (8, 1024, 16, 2, 128, 1)]
if os.environ.get("NONCAUSAL"):     # every block walks every tile
    SHAPES += [(8, 1024, 14, 14, 64, 0), (8, 1024, 14, 2, 64, 0)]


def sub(src, old, new):
    assert old in src, old[:60]
    return src.replace(old, new)


def nolse(src):
    return sub(src, """          vr[r] = i < mask.Sq ? lse[row + i] * kLog2e : 0.0f;
          vr[64 + r] = i < mask.Sq ? delta[row + i] : 0.0f;""",
               """          vr[r] = 0.0f * row * i;
          vr[64 + r] = 0.0f;""")


def nw2(src):
    return sub(src, "static constexpr int NW = D == 128 ? 2 : 1;",
               "static constexpr int NW = D >= 64 ? 2 : 1;")


def _epilogue(src):
    a = src.index("  cluster_barrier();\n  const int span")
    b = src.index("// (c) dQ.")
    return a, b


def lepi(src):
    """Each block's f32 dK, dV into its own shared memory, then block q
    reads its rows from every block (all c remote loads issued before the
    sum), a third cluster barrier before any block leaves."""
    a, b = _epilogue(src)
    body = """  cluster_barrier();
  float* part = reinterpret_cast<float*>(smem);   // [2 ROWS][PITCH]
#pragma unroll
  for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
    for (int i = 0; i < T::DW / 2; i += 2) {
      const int r = 64 * cw + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = cc * T::DW + 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(part + r * PITCH + col) =
          make_float2(ak[cc][i], ak[cc][i + 1]);
      *reinterpret_cast<float2*>(part + (ROWS + r) * PITCH + col) =
          make_float2(av[cc][i], av[cc][i + 1]);
    }
  cluster_barrier();
  constexpr int Q4 = D / 4;
  const int span = (2 * ROWS + c - 1) / c;
  const int n = min(span, 2 * ROWS - rank * span) * Q4;
  for (int e = tid - 128; e < n; e += NW * 128) {
    const int R = rank * span + e / Q4, c4 = e % Q4;
    const float* at = part + R * PITCH + 4 * c4;
    float4 x[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < c) x[q] = load_remote(at, q);
    float4 sum = x[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < c) {
        sum.x += x[q].x;
        sum.y += x[q].y;
        sum.z += x[q].z;
        sum.w += x[q].w;
      }
    const int which = R >= ROWS;
    const int j = k0 + R - which * ROWS;
    if (j < Skv) {
      const float m = which ? 1.0f : scale;
      uint2 o;
      o.x = pack(sum.x * m, sum.y * m);
      o.y = pack(sum.z * m, sum.w * m);
      *reinterpret_cast<uint2*>((which ? dv : dk) +
                                (((long long)b * Skv + j) * Hkv + hk) * D +
                                4 * c4) = o;
    }
  }
  cluster_barrier();
}

"""
    src = src[:a] + body + src[b:]
    src = sub(src, """    cluster_barrier();                  // every block is done with its
    cluster_barrier();                  // tiles; the slots are filled
""", """    cluster_barrier();
    cluster_barrier();
    cluster_barrier();
""")
    return sub(src, """// (x, y) at `local`'s offset""", """__device__ __forceinline__ float4 load_remote(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// (x, y) at `local`'s offset""")


def tinyepi(src):
    """No cluster sum and almost no store: each thread adds its dK, dV
    values and one thread a warp stores the sum (wrong results: shows what
    the epilogue costs against the walk)."""
    a, b = _epilogue(src)
    tiny = """  cluster_barrier();
  float t = 0.0f;
#pragma unroll
  for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
    for (int i = 0; i < T::DW / 2; ++i) t += ak[cc][i] + av[cc][i];
  if (lane == 0)
    dk[(((long long)b * Skv + k0) * Hkv + hk) * D + warp + 4 * cw] =
        __float2bfloat16(t);
  cluster_barrier();
}

"""
    return src[:a] + tiny + src[b:]


def nostart(src):
    """The producer loads K, V and the first stage only after a spin of
    ~2 us (wrong timing on purpose: shows how start-up latency moves the
    kernel)."""
    return sub(src, """    regs_down<T::PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, NW * 2 * TILE);""", """    regs_down<T::PRODUCER_REGS>();
    if (warp == 0) {
      const long long t_0 = clock64();
      while (clock64() - t_0 < 3600) {
      }
      if (lane == 0) {
        mbar_expect_tx(kv_bar, NW * 2 * TILE);""")


def dq3(src):
    """The dQ kernel at D <= 64 with three blocks an SM: launch bounds for
    three, the consumers' setmaxnreg at 136 (80 a thread at launch)."""
    a = src.index("flash_bwd_dq_wgmma_kernel(const __grid_constant__")
    head, tail = src[:a], src[a:]
    head = head[:head.rindex("__launch_bounds__(Tile<D>::THREADS, "
                             "Tile<D>::BLOCKS)")] + (
        "__launch_bounds__(Tile<D>::THREADS, Tile<D>::NW == 1 ? 3 : 1)\n")
    tail = sub(tail, "  regs_up<T::CONSUMER_REGS>();",
               "  regs_up<T::NW == 1 ? 136 : T::CONSUMER_REGS>();")
    return head + tail


TRANSFORMS = {"nolse": nolse, "nw2": nw2, "lepi": lepi, "tinyepi": tinyepi,
              "nostart": nostart, "dq3": dq3}


def build_variant(name, src):
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    so = OUT / f"lib{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def max_reg(so):
    """The highest register each bf16 kernel's SASS names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "wgmma_kernel" in fn:
            for r in re.findall(r"\bR(\d+)\b", line):
                key = re.sub(r".*flash_bwd_(\w+?)_wgmma_kernelILi(\d+).*",
                             r"\1 D=\2", fn)
                out[key] = max(out.get(key, 0), int(r))
    return out


def lib_fn(so):
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    variants = []
    for arg in sys.argv[1:]:
        name, _, spec = arg.partition("=")
        names = [t for t in spec.split("+") if t]
        src = SRC
        for t in names:
            if t.startswith("@"):
                src = Path(t[1:]).read_text()
            elif not re.fullmatch(r"c\d+", t):
                src = TRANSFORMS[t](src)
        variants.append((name, names, src))
    cs.CARD = cs.card_line()
    print(cs.CARD, flush=True)
    build.build(("flash_attention", "flash_attention_bwd"))
    procs = [(n, t, build_variant(n, s)) for n, t, s in variants]
    fns = {}
    for n, t, (p, so) in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{log}")
        fn_name = "?"
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn_name = re.sub(r".*flash_bwd_(\w+?_kernel)I\w*?Li(\d+)E.*",
                                 r"\1 D=\2", m.group(1))
            if ("spill" in line and " 0 bytes spill" not in line) or \
                    "erformance" in line or "serializ" in line:
                print(f"{n} {fn_name}: {line.strip()}")
        print(f"{n} ({'+'.join(t) or 'source'}): max register "
              f"{max_reg(so)}", flush=True)
        if os.environ.get("SASS_DIR"):
            tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            Path(os.environ["SASS_DIR"]).mkdir(parents=True, exist_ok=True)
            (Path(os.environ["SASS_DIR"]) / f"{n}.sass").write_text(
                subprocess.run([tool, "-sass", str(so)], capture_output=True,
                               text=True).stdout)
        size = [int(x[1:]) for x in t if re.fullmatch(r"c\d+", x)]
        fns[n] = (lib_fn(so), size[0] if size else None)
    _, _, fn_ref = _bwd_entry()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    order = [v[0] for v in variants]
    order = order + order[::-1]
    for B, S, Hq, Hkv, D, causal in SHAPES:
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for h in (Hq, Hkv, Hkv, Hq))
        out, lse = flash_attention_kernel(q, k, v, lse=True,
                                          causal=bool(causal))
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]

        def call(fn, which, c):
            err = fn(which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(),
                     *(g.data_ptr() for g in grads), B, S, S, Hq, Hkv, D, S,
                     0, causal, 0, 1.0 / math.sqrt(D), 1, c, stream)
            assert err == 0, err

        G = Hq // Hkv
        rule = bwd_cluster(B, S, S, Hq, Hkv, D, causal=bool(causal),
                           window=0, kv_len=S, offset=0,
                           sms=torch.cuda.get_device_properties(0)
                           .multi_processor_count)
        call(fn_ref, 2, rule)                   # dq (and delta) first
        call(fn_ref, 1, rule)
        ref = [g.clone() for g in grads]
        times = {}
        for n in order:
            fn, size = fns[n]
            c = min(size, G) if size else rule
            for which in (2, 1):
                for _ in range(3):
                    call(fn, which, c)
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    call(fn, which, c)
                z.record()
                torch.cuda.synchronize()
                times.setdefault((n, which), []).append(
                    a.elapsed_time(z) / 20 * 1e3)
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(grads, ref))
            times.setdefault((n, "err"), []).append(err)
        for n in order[:len(variants)]:
            print(f"({B}, {S}, {Hq} / {Hkv}, {D}"
                  f"{'' if causal else ', non-causal'}; rule c = {rule}) "
                  f"{n}: dk/dv "
                  f"{' / '.join(f'{t:.2f}' for t in times[(n, 1)])} us, dq "
                  f"{' / '.join(f'{t:.2f}' for t in times[(n, 2)])} us, "
                  f"max |diff| vs the package {max(times[(n, 'err')]):.3g} "
                  f"[{cs.CARD}]", flush=True)


if __name__ == "__main__":
    main()
