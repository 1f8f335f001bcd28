"""Runs chip_smoke.py's phase 20 alone on the card (its CPU reference in
a child process), in the order of the whole run: (a), (c), (e), (d),
(b)."""
import json
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.CARD = chip_smoke.card_line()
print(chip_smoke.CARD, torch.__version__, torch.version.cuda)
t0 = time.time()
ref = chip_smoke.start_cpu_references(("audio",))
build.build(("flash_attention", "flash_attention_bwd"))
print("build", time.time() - t0)
out = chip_smoke.audio_train_phase(torch, ref)
os.makedirs("chiprun_out", exist_ok=True)
with open("chiprun_out/phase20.json", "w") as f:
    json.dump(out, f, default=str, indent=1)
print("phase 20", time.time() - t0)
