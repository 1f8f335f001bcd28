#!/usr/bin/env python3
"""Time text variants of ``csrc/wkv6_bwd.cu`` against the source as it
stands, and optionally an earlier design of the kernel, in one process on
one card.

    python3 experiments/wkv6_bwd_variants.py NAME=[TRANSFORM[+...]] ...
        [--parent FILE] [--shape B,S,H,hd] ... [--dtype bfloat16|float32]
        [--sass DIR]

``NAME=`` with no transform is the source itself.  A transform is a key
of ``EDITS``: ``t8`` (8 steps a ring stage at hd >= 32, half the shared
memory), ``u2`` / ``u8`` (2 or 8 steps a group: the lanes' exchanges and
pass B's barrier once every 2 or 8 steps), ``ns3`` (three ring stages),
``b3`` (pass B held to three blocks an SM, with ``t8``), ``c1`` (hd
128's pass B at one block an SM, 16 steps a stage, as first built).  Variants that
give wrong results, to see what a part costs: ``nodk`` (pass B without
dk''s partials, their barrier and sums), ``nodv`` (pass B without dv's
exchanges), ``nowalk`` (no walk of log w's gradient).

``--parent FILE`` adds the kernel of an earlier commit, for example the
checkpointing design of 6d48bd2 (``git show
6d48bd2:src/repro_torch/kernels/csrc/wkv6_bwd.cu > FILE``, FILE in a
directory that ``.gitignore`` lists), bound through its own C entry
(dw, checkpoints) and timed in the same order as an A/B; its agreement
is held against dw, the variants' against w dw.

``--shape`` names the shapes (default: the rwkv6-3b loss (8, 1024, 40,
64)); ``--dtype`` r, k, v's (default bfloat16).  ``--sass DIR`` writes
each variant's SASS (``cuobjdump -sass``) into DIR.

Each variant is built with the package's nvcc flags, its ptxas lines at
hd = 64 and 128 printed, its gradients' largest difference from
``wkv6_bwd_plain`` over their largest magnitude printed (not asserted),
and timed as ``chip_smoke.py`` times the kernel (CUDA-graph replays over
input sets of at least twice the L2), in the order a, b, ..., b, a, then
each pass of each variant alone.
Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
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
from repro_torch.kernels.wkv6 import (_bwd_buffers, _bwd_pointers,  # noqa
                                      wkv6_bwd_plain)

SRC = (build.CSRC / "wkv6_bwd.cu").read_text()
_T = "  static constexpr int T = HD == 128 ? 8 : 16;   // steps a stage\n"
_U = ("  static constexpr int U = 4;              // steps a group (one "
      "reduction)\n")
_DKSUM = "          float d = pb[x * K::SLOTS * HD + i];\n"

# name -> [(old text, new text), ...]
EDITS = {
    "t8": [(_T, "  static constexpr int T = HD == 16 ? 16 : 8;\n")],
    "u2": [(_U, "  static constexpr int U = 2;\n")],
    "u8": [(_U, "  static constexpr int U = 8;\n")],
    "ns3": [("static constexpr int NS = 2;", "static constexpr int NS = 3;")],
    "c1": [(_T, "  static constexpr int T = 16;\n"),
           ("static constexpr int MINB_B = 2;",
            "static constexpr int MINB_B = HD == 128 ? 1 : 2;")],
    "b3": [(_T, "  static constexpr int T = HD == 16 ? 16 : 8;\n"),
           ("static constexpr int MINB_B = 2;",
            "static constexpr int MINB_B = HD == 64 ? 3 : 2;")],
    # wrong results, to see what a part costs
    "nodk": [("    reinterpret_cast<float4*>(pb + (x * K::SLOTS + ln.slot) * "
              "HD)[ln.p] =\n        make_float4(q[0], q[1], q[2], q[3]);\n",
              "    if (q[0] == 12345.0f) pb[0] = q[1] + q[2] + q[3];\n"),
             ("      consumers_sync(NT);\n      if constexpr (SPLIT) {",
              "      if constexpr (SPLIT) {"),
             (_DKSUM, "          float d = 0.0f;\n"),
             ("#pragma unroll\n          for (int sl = 1; sl < K::SLOTS; "
              "++sl)\n            d += pb[(x * K::SLOTS + sl) * HD + i];\n",
              "")],
    "nodv": [("  Red::reduce(o, ln.p);\n  const int f = Red::first(ln.p);\n"
              "  if (f >= 0) {\n    const float* sa",
              "  const int f = Red::first(ln.p);\n"
              "  if (f >= 0) {\n    const float* sa")],
    "nowalk": [("        if (grp > 0 && tid < HD)\n",
                "        if (grp < 0 && tid < HD)\n")],
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
    specs, shapes, dtype, sass, parent, i = [], [], torch.bfloat16, None, \
        None, 0
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
        elif args[i] == "--parent":
            parent = Path(args[i + 1])
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
    if parent is not None:
        variants["parent"] = (["parent"], parent.read_text())
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
            if "ILi64E" in fn or "ILi128E" in fn:
                print(f"  {name} {fn[-40:]}: {line}")
        path = build.library_path(f"wkvb_{name}")
        if sass is not None:
            sass.mkdir(parents=True, exist_ok=True)
            with open(sass / f"wkvb_{name}.sass", "w") as f:
                subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                                str(path)], stdout=f, check=False)
        lib = ctypes.CDLL(str(path))
        f = lib.wkv6_bwd if name == "parent" else lib.wkv6_bwd_passes
        n_ptr, n_int = (17, 5) if name == "parent" else (16, 6)
        f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f

    def call(name, r, k, v, w, u, s0, dy, dsT, passes=3):
        B, S, H, hd = r.shape
        stream = torch.cuda.current_stream().cuda_stream
        bf16 = int(r.dtype == torch.bfloat16)
        if name == "parent":         # 6d48bd2's entry: checkpoints, dw
            f32 = dict(dtype=torch.float32, device=r.device)
            outs = [torch.empty(r.shape, **f32) for _ in range(4)]
            du = torch.empty((H, hd), **f32)
            ds0 = torch.empty_like(s0)
            du_part = torch.empty((B, H, hd), **f32)
            tc = 16 if hd <= 32 else 8
            ncb = 4 if hd == 128 else 1
            ck = torch.empty(B * H * -(-S // tc) * hd * hd, **f32)
            part = torch.empty((3, ncb) + tuple(r.shape) if ncb > 1
                               else (1,), **f32)
            ptrs = (r, k, v, w, u, s0, dy, dsT, *outs, du, ds0, ck, du_part,
                    part)
            err = fns[name](*(t.data_ptr() for t in ptrs), B, S, H, hd,
                            bf16, stream)
            got = (*outs, du, ds0)
        else:
            o = _bwd_buffers(r)
            err = fns[name](*_bwd_pointers((r, k, v, w, u, s0, dy), dsT, o),
                            B, S, H, hd, bf16, passes, stream)
            got = tuple(o[x] for x in ("dr", "dk", "dv", "dlw", "du", "ds0"))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return got

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
        want = {lw: wkv6_bwd_plain(*args, log_w=lw) for lw in (False, True)}
        agree = {}
        for n in names:
            got = call(n, *args)
            agree[n] = max(((g - x).abs().max() / x.abs().max()).item()
                           for g, x in zip(got, want[n != "parent"]))
        del want
        nbytes = cs.wkv_bwd_bytes(*shape, es)
        sets = [inputs(*shape)
                for _ in range(max(2, -(-2 * cs.L2_BYTES // nbytes)))]
        times = {n: [] for n in names}
        for n in order:
            ms, _ = cs.time_calls(torch, lambda *a, n=n: call(n, *a), sets,
                                  3)
            times[n].append(ms * 1e3)
        # each pass alone (pass B reads the dr of a whole call before it)
        alone = {}
        for n in names:
            if n == "parent":
                continue
            alone[n] = [cs.time_calls(torch, lambda *a, n=n, p=p: call(
                n, *a, passes=p), sets, 3)[0] * 1e3 for p in (1, 2)]
        b_us = nbytes / cs.HBM_BYTES_PER_S * 1e6
        s_us = cs.wkv_bwd_slots(*shape) / cs.F32_SLOTS_PER_S * 1e6
        fl = cs.wkv_bwd_pass_floors(*shape, es)
        floor = (max(fl[0], fl[1]) + max(fl[2], fl[3])) * 1e6
        print(f"{shape} {str(dtype)[6:]} [{cs.CARD}], bound "
              f"{max(b_us, s_us):.2f} us (issue slots {s_us:.2f}, bytes "
              f"{b_us:.2f}), the two passes' floor {floor:.2f} us (pass A "
              f"{max(fl[0], fl[1]) * 1e6:.2f}, pass B "
              f"{max(fl[2], fl[3]) * 1e6:.2f}), {len(sets)} input sets:")
        for n in names:
            each = "" if n not in alone else (
                f"; pass A alone {alone[n][0]:.2f} us, pass B "
                f"{alone[n][1]:.2f}")
            print(f"  {n} ({'+'.join(variants[n][0]) or 'source'}): "
                  f"{' / '.join(f'{v:.2f}' for v in times[n])} us "
                  f"({100 * max(b_us, s_us) / times[n][0]:.1f} % of the "
                  f"bound{each}; gradients within {agree[n]:.2e} of their "
                  f"largest magnitudes)")
        del sets


if __name__ == "__main__":
    main()
