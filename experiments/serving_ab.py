#!/usr/bin/env python3
"""The serving phase of ``chip_smoke.py`` alone, from one source tree:
qwen2-0.5b at full width serving the phase's 16 requests, then a
``torch.profiler`` window over 6 engine steps.

    python3 experiments/serving_ab.py [ROOT]

ROOT (default: this checkout) is the root of the tree whose
``chip_smoke.py`` and ``src/`` are used, so that two trees can be compared
in one call on one card, in turns: parent, change, change, parent.  Needs
a CUDA card and nvcc; builds the tree's kernels at first use.
"""
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = cs.card_line()
    print(f"{cs.CARD}; tree {ROOT}")
    *_, eng, spec, _cfg = cs.serving_phase(torch)
    cs.profile_phase(torch, eng, spec)


if __name__ == "__main__":
    main()
