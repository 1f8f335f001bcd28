"""Writes 30 GiB of files into a temporary directory and removes them,
three times, with a pause after each (90 GiB written, 30 GiB held at
once): on a machine that caps what a run may write to its disk, it shows
whether the cap counts every byte written or the most held at once.

    python3 experiments/disk_probe.py
"""
import os, time, shutil, tempfile
import numpy as np
buf = np.random.default_rng(0).integers(0, 2**63, 2**27, dtype=np.int64).tobytes()  # 1 GiB
t0 = time.time()
for rnd in range(3):
    d = tempfile.mkdtemp(prefix="probe_")
    for i in range(30):
        with open(os.path.join(d, f"f{i}"), "wb") as f:
            f.write(buf)
    print(f"round {rnd}: 30 GiB written, {time.time() - t0:.1f} s", flush=True)
    shutil.rmtree(d)
    print(f"round {rnd}: removed, {time.time() - t0:.1f} s", flush=True)
    time.sleep(20)
print("done", time.time() - t0)
