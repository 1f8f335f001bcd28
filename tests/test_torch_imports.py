"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``
(only the tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in FILES[:-1]}
    for mod in ("nn/types.py", "configs/qwen2_0_5b.py", "kernels/build.py",
                "kernels/paged_gather.py", "kernels/paged_attention.py",
                "kernels/ops.py", "nn/layers.py", "nn/blocks.py",
                "nn/model.py", "quant/ptq.py", "runtime/kvcache.py",
                "runtime/serve.py", "launch/serve.py",
                "configs/pendigits_mlp.py", "data/pendigits.py",
                "core/csd.py", "core/intmlp.py", "core/mcm.py",
                "core/planner.py", "core/quantize.py", "core/tuning.py",
                "kernels/csd_matvec.py", "train/zaal.py", "eval/batched.py",
                "eval/torchtail.py", "eval/__init__.py",
                "launch/quickstart.py"):
        assert mod in names, mod
    assert (ROOT / "chip_smoke.py").exists()
    assert (ROOT / "src/repro_torch/kernels/csrc/csd_matvec.cu").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
