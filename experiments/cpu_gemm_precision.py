"""The host CPU's f32 GEMM and einsum error against f64 at phase 19
(c)'s shapes, with PyTorch's defaults and with oneDNN off."""
import time

import torch

torch.set_num_threads(4)
print(torch.__version__, torch.get_float32_matmul_precision(),
      getattr(getattr(torch.backends.mkldnn, "matmul", None),
              "fp32_precision", "n/a"),
      torch.backends.mkldnn.is_available())
print(torch.__config__.show())
print(torch.__config__.parallel_info())
torch.manual_seed(0)
cases = [(3008, 7168, 7168), (3008, 7168, 20480), (3008, 20480, 7168),
         (7168, 3008, 20480), (3008, 1024, 7168)]
for mk in (True, False):
    with torch.backends.mkldnn.flags(enabled=mk):
        for (m, k, n) in cases:
            a, b = torch.randn(m, k), torch.randn(k, n)
            t = time.time()
            c = a @ b
            t = time.time() - t
            c64 = a.double() @ b.double()
            err = ((c.double() - c64).abs().max() / c64.abs().max()).item()
            print(f"mkldnn {mk} {m}x{k}x{n}: {err:.3e} ({t:.2f} s)",
                  flush=True)
        q = torch.randn(1, 3008, 8, 7, 128)
        kk = torch.randn(1, 512, 8, 128)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, kk)
        s64 = torch.einsum("bqhgd,bkhd->bhgqk", q.double(), kk.double())
        print(f"mkldnn {mk} einsum",
              ((s.double() - s64).abs().max() / s64.abs().max()).item())
        x = torch.randn(3008, 7168)
        r = torch.rsqrt(x.square().mean(-1) + 1e-6)
        r64 = torch.rsqrt(x.double().square().mean(-1) + 1e-6)
        print("rsqrt", ((r.double() - r64).abs() / r64).max().item())
        e = torch.exp(x)
        print("exp", ((e.double() - x.double().exp()).abs()
                      / x.double().exp()).max().item())
