"""Where phase 19 (c)'s f32 gradient differs: at full width, 2 layers,
vocab 4096, one row of 2880 patches and T tokens, each leaf's gradient
from (A) the card's kernels, (B) autograd through the plain attention on
the card, (C) the CPU (T = 128, from the child process) held against (E)
an f64 gradient on the card (f64 leaves, f64 attention)."""
import dataclasses
import math
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa
from repro_torch.nn import Model  # noqa: E402
from repro_torch.nn.types import ShapeSpec  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, tree_map  # noqa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(chip_smoke.card_line())
ref = chip_smoke.start_cpu_references(("vlm",))
build.build(("flash_attention", "flash_attention_bwd"))
kernel_op = K.flash_attention


def plain_op(q, k, v, *, causal=True, window=0, bk=256, offset=None):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 bk=bk, offset=offset)


def f64_op(q, k, v, *, causal=True, window=0, bk=256, offset=None):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, S, Hq, D)


def grads(cfg, params, batch, op, dtype=None):
    K.flash_attention = op
    try:
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype="float64")
            params = tree_map(lambda p: p.double(), params)
        live = tree_map(lambda p: p.detach().to("cuda").requires_grad_(),
                        params)
        loss, _ = Model(cfg, device="cuda").loss(live, batch)
        g = torch.autograd.grad(loss, leaves(live))
        return float(loss), [x.double().cpu() for x in g]
    finally:
        K.flash_attention = kernel_op


def compare(label, got, truth, names):
    rels = []
    for name, a, w in zip(names, got[1], truth[1]):
        rels.append(((a - w).abs().max().item() / w.abs().max().item(),
                     name))
    rels.sort(reverse=True)
    print(f"{label}: loss {got[0]!r} vs {truth[0]!r}; worst leaves "
          + ", ".join(f"{n} {r:.3e}" for r, n in rels[:6]), flush=True)


for T in (128, 192):
    cfg, params, _ = chip_smoke.vlm_grad_inputs(torch)
    batch = chip_smoke.SpecBatches(
        cfg, ShapeSpec("vlm grad", cfg.n_patches + T, 1, "train"),
        1).batch(0)
    names = ["/".join(map(str, p)) for p, _ in flatten_with_path(params)]
    t0 = time.time()
    E = grads(cfg, params, batch, f64_op, torch.float64)
    A = grads(cfg, params, batch, kernel_op)
    B = grads(cfg, params, batch, plain_op)
    print(f"T = {T}: {time.time() - t0:.1f} s", flush=True)
    compare(f"T {T} (A) kernels vs f64", A, E, names)
    compare(f"T {T} (B) plain on the card vs f64", B, E, names)
    compare(f"T {T} (A) kernels vs (B) plain on the card", A, B, names)
    if T == 128:
        cpu = chip_smoke.wait_cpu_reference(ref, "vlm")
        C = (cpu["loss"], [x.double() for x in cpu["grads"]])
        print(f"CPU {cpu['secs']:.1f} s")
        compare("(C) CPU vs f64", C, E, names)
        compare("(A) kernels vs (C) CPU", A, C, names)
        compare("(B) plain on the card vs (C) CPU", B, C, names)
    del E, A, B
