"""Where the host CPU's f32 forward of phase 19 (c)'s model leaves the
card's: the same loss forward (full width, 2 layers, vocab 4096, 2880
patches + 128 tokens) on the CPU (4 threads, as the child) and on the
card in f32 and in f64, with every decoder layer's input and output, its
attention's q, k, v and output and its MLP's input and output recorded;
each point's largest difference over its largest magnitude against the
card's f64."""
import dataclasses
import math
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.nn import Model, blocks, layers  # noqa: E402
from repro_torch.nn import model as model_mod  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(4)
build.build(("flash_attention", "flash_attention_bwd"))
rec = []
flash, mlp, rms = K.flash_attention, blocks.mlp_apply, model_mod.rms_norm


def f64_op(q, k, v, *, causal=True, window=0, bk=256, offset=None):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, S, Hq, D)


def run(device, dtype):
    cfg, params, batch = chip_smoke.vlm_grad_inputs(torch)
    cfg = dataclasses.replace(cfg, remat=False, dtype=dtype)
    params = tree_map(lambda p: p.to(device, getattr(torch, dtype)), params)
    rec.clear()

    def att(q, k, v, **kw):
        out = (f64_op if dtype == "float64" else flash)(q, k, v, **kw)
        rec.extend([("q", q), ("k", k), ("v", v), ("attn out", out)])
        return out

    def mlp_rec(p, h):
        out = mlp(p, h)
        rec.extend([("mlp in", h), ("mlp out", out)])
        return out

    def rms_rec(x, scale, eps=1e-6):
        out = rms(x, scale, eps)
        rec.extend([("norm in", x), ("norm out", out)])
        return out
    K.flash_attention, blocks.mlp_apply, model_mod.rms_norm = \
        att, mlp_rec, rms_rec
    try:
        with torch.no_grad():
            loss, _ = Model(cfg, device=device).loss(params, batch)
    finally:
        K.flash_attention, blocks.mlp_apply, model_mod.rms_norm = \
            flash, mlp, rms
    return float(loss), [(n, t.detach().double().cpu()) for n, t in rec]


truth = run("cuda", "float64")
for label, dev in (("card f32", "cuda"), ("CPU f32", "cpu")):
    got = run(dev, "float32")
    print(f"{label}: loss {got[0]!r} against f64 {truth[0]!r}")
    for i, ((n, a), (_, w)) in enumerate(zip(got[1], truth[1])):
        err = (a - w).abs().max().item() / w.abs().max().item()
        print(f"  {i:2d} {n:9s} {tuple(a.shape)} {err:.3e}")
