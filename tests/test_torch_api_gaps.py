"""The reference's remaining small public names, at its paths in
repro_torch, against the JAX package on the CPU:

- ``nn.types``: ``ShapeSpec``, ``SHAPES`` and ``applicable_shapes`` equal
  the reference's for every config, and ``list_configs()`` is the same
  list in both packages (every reference config is ported);
- ``nn.layers``: ``gelu_mlp`` (the tanh GELU, as ``jax.nn.gelu``'s
  default; the erf form is off by more than the tolerance) and ``cast``;
- ``kernels.ref``: ``qmatmul_ref`` and ``csd_matvec_ref`` bit for bit,
  ``flash_attention_ref`` within 1e-6 (causal, windowed, Sq < Skv);
  ``kernels.linear_scan.linear_scan_ref`` bit for bit;
- the kernel modules' ``flash_attention``, ``linear_scan``, ``qmatmul``
  and ``csd_matvec`` are the ops ``repro_torch.kernels`` exports, and
  each agrees with the reference module's name of the same spelling, run
  in interpret mode as the reference's tests run it;
- ``repro_torch.train`` exports ``TrainConfig`` and ``train``,
  ``repro_torch.data`` exports ``pendigits``."""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:    # the JAX package is the oracle
    import jax
    import jax.numpy as jnp
    from repro.core.csd import to_csd_array
    from repro.kernels import ref as jref
    from repro.nn import layers as jlayers
    from repro.nn import types as jtypes
except ImportError:
    jax = None
import repro_torch.kernels as tkernels
from repro_torch.kernels import ref as tref
from repro_torch.nn import layers as tlayers
from repro_torch.nn import types as ttypes

RNG_SEED = 7
KERNEL_MODULES = ("flash_attention", "linear_scan", "qmatmul", "csd_matvec")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_list_configs_equal():
    assert ttypes.list_configs() == jtypes.list_configs()
    assert len(ttypes.list_configs()) == 10


@pytest.mark.parametrize("name", jtypes.list_configs() if jax else [])
def test_shapes_and_applicable_shapes(name):
    """The shape grid and its skip rule: ``long_500k`` only where the
    config is subquadratic (rwkv6-3b, recurrentgemma-9b)."""
    assert {k: dataclasses.asdict(v) for k, v in ttypes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jtypes.SHAPES.items()}
    cfg, jcfg = ttypes.get_config(name), jtypes.get_config(name)
    got = [dataclasses.asdict(s) for s in ttypes.applicable_shapes(cfg)]
    want = [dataclasses.asdict(s) for s in jtypes.applicable_shapes(jcfg)]
    assert got == want
    assert ("long_500k" in [s["name"] for s in got]) == cfg.subquadratic
    assert ttypes.ShapeSpec("x", 8, 2, "decode") == ttypes.ShapeSpec(
        "x", 8, 2, "decode")


def test_nn_package_exports():
    import repro_torch.nn as tnn
    for name in ("ShapeSpec", "SHAPES", "applicable_shapes"):
        assert getattr(tnn, name) is getattr(ttypes, name)
        assert name in ttypes.__all__


def test_gelu_mlp_matches_jax():
    """Within 1e-6 of the reference in f32; ``F.gelu``'s erf form is off
    by more, so the tanh form is the one held."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(0, 1, (3, 5, 16)).astype(np.float32)
    w_in = rng.normal(0, 0.5, (16, 32)).astype(np.float32)
    b_in = rng.normal(0, 0.5, (32,)).astype(np.float32)
    w_out = rng.normal(0, 0.5, (32, 16)).astype(np.float32)
    b_out = rng.normal(0, 0.5, (16,)).astype(np.float32)
    want = np.asarray(jlayers.gelu_mlp(*map(jnp.asarray, (x, w_in, b_in,
                                                          w_out, b_out))))
    args = tuple(map(_t, (x, w_in, b_in, w_out, b_out)))
    got = tlayers.gelu_mlp(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = (F.gelu(args[0] @ args[1] + args[2]) @ args[3] + args[4]).numpy()
    assert np.abs(erf - want).max() > 1e-6


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast(dtype):
    x = np.random.default_rng(RNG_SEED).normal(0, 1, (4, 6)).astype(
        np.float32)
    got = tlayers.cast(_t(x), dtype)
    want = np.asarray(jlayers.cast(jnp.asarray(x), dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def _xla_exact(e):
    """Columns whose scale XLA's CPU exp2 gives exactly (it is inexact at
    some integer exponents, 13 and -13 among them)."""
    xla = np.asarray(jnp.exp2(-jnp.asarray(e).astype(jnp.float32)))
    return xla == np.ldexp(np.float32(1), -e).astype(np.float32)


def _qmm_inputs(M, K, N, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    e = rng.integers(-8, 12, N).astype(np.int32)
    return x, w, e


def test_qmatmul_ref_bit_equal():
    """int32 sums, then the power-of-two scale: bit for bit the
    reference's oracle on the columns its ``exp2`` gives exactly."""
    x, w, e = _qmm_inputs(33, 300, 40)
    exact = _xla_exact(e)
    assert exact.sum() >= 30
    want = np.asarray(jref.qmatmul_ref(*map(jnp.asarray, (x, w, e))))
    got = tref.qmatmul_ref(_t(x), _t(w), _t(e)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, exact], want[:, exact])


def test_csd_matvec_ref_bit_equal():
    """sum_d (x @ plane_d) << d in int32, an int32 wrap included."""
    rng = np.random.default_rng(RNG_SEED)
    W = rng.integers(-(1 << 20), 1 << 20, (24, 9))
    planes = to_csd_array(W)
    x = rng.integers(-(1 << 14), 1 << 14, (17, 24)).astype(np.int32)
    want = np.asarray(jref.csd_matvec_ref(jnp.asarray(x),
                                          jnp.asarray(planes)))
    got = tref.csd_matvec_ref(_t(x), _t(planes)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    exact = x.astype(np.int64) @ W.astype(np.int64)
    assert (exact != got).any()                       # a sum wrapped
    np.testing.assert_array_equal(got, exact.astype(np.int32))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window", [
    (2, 16, 16, 4, 2, 8, True, 0),
    (1, 12, 40, 4, 1, 16, True, 0),      # Sq < Skv: bottom-right aligned
    (2, 24, 24, 4, 4, 8, True, 6),       # window
    (1, 10, 30, 2, 2, 8, False, 0),      # non-causal
    (1, 8, 20, 2, 1, 8, True, 4),        # a window and Sq < Skv
])
def test_flash_attention_ref_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal,
                                         window):
    rng = np.random.default_rng(RNG_SEED)
    q = rng.normal(0, 1, (B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32)
    want = np.asarray(jref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                   window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,S,W", [(2, 64, 128), (1, 100, 70),
                                   (2, 256, 256)])
def test_linear_scan_ref_bit_equal(B, S, W):
    """The reference's oracle at its tests' shapes and inputs, bit for bit
    in int32 views (its step is one fused multiply-add)."""
    from repro.kernels.linear_scan import linear_scan_ref as jscan_ref
    from repro_torch.kernels.linear_scan import linear_scan_ref
    rng = np.random.default_rng(4)
    a = rng.uniform(0.7, 1.0, (B, S, W)).astype(np.float32)
    x = rng.normal(0, 0.1, (B, S, W)).astype(np.float32)
    want = np.asarray(jscan_ref(jnp.asarray(a), jnp.asarray(x)))
    got = linear_scan_ref(_t(a), _t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_module_wrapper_is_the_package_op(name):
    """``from repro_torch.kernels.<name> import <name>`` gives the op the
    package exports (``ops.py``'s), and the package attribute stays the
    op, not the module."""
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    ops = importlib.import_module("repro_torch.kernels.ops")
    assert getattr(module, name) is getattr(tkernels, name) \
        is getattr(ops, name)
    assert callable(getattr(tkernels, name))
    assert not isinstance(getattr(tkernels, name), type(module))


def test_module_wrappers_bound_on_a_fresh_import():
    code = ("from repro_torch.kernels.flash_attention import flash_attention;"
            "from repro_torch.kernels.linear_scan import linear_scan;"
            "from repro_torch.kernels.qmatmul import qmatmul;"
            "from repro_torch.kernels.csd_matvec import csd_matvec;"
            "import repro_torch.kernels as k;"
            "assert k.flash_attention is flash_attention;"
            "assert k.qmatmul is qmatmul and k.csd_matvec is csd_matvec;"
            "assert k.linear_scan is linear_scan")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (src, os.environ.get("PYTHONPATH")))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


def test_flash_attention_wrapper_matches_jax():
    """The reference's ``flash_attention`` (its Pallas kernel in interpret
    mode, bq = bk = 64, as its tests run it) and the port's, bq and
    interpret ignored: within the reference test's 2e-5."""
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 100, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 160, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 160, 2, 32)).astype(np.float32)
    for causal, window in ((True, 0), (True, 40), (False, 0)):
        want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                                 causal=causal, window=window, bq=64,
                                 bk=64))
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, bq=64, bk=64,
                              interpret=True).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_linear_scan_wrapper_matches_jax():
    from repro.kernels.linear_scan import linear_scan as jscan
    from repro_torch.kernels.linear_scan import linear_scan
    rng = np.random.default_rng(4)
    a = rng.uniform(0.7, 1.0, (1, 100, 70)).astype(np.float32)
    x = rng.normal(0, 0.1, (1, 100, 70)).astype(np.float32)
    want = np.asarray(jscan(jnp.asarray(a), jnp.asarray(x), bt=32, bw=64))
    got = linear_scan(_t(a), _t(x), bt=32, bw=64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_qmatmul_wrapper_matches_jax():
    """The reference module's ``qmatmul`` (its Pallas kernel, tiles of
    256 x 256 x 512, interpret mode) and the port's op: bit for bit on the
    columns XLA's ``exp2`` gives exactly; ``out_dtype`` bf16 the f32
    result rounded once."""
    from repro.kernels.qmatmul import qmatmul as jqmm
    from repro_torch.kernels.qmatmul import qmatmul
    x, w, e = _qmm_inputs(256, 512, 256)
    exact = _xla_exact(e)
    want = np.asarray(jqmm(*map(jnp.asarray, (x, w, e)), interpret=True))
    got = qmatmul(_t(x), _t(w), _t(e), bm=256, bn=256, bk=512)
    np.testing.assert_array_equal(got.numpy()[:, exact], want[:, exact])
    half = qmatmul(_t(x), _t(w), _t(e), out_dtype=torch.bfloat16)
    assert torch.equal(half, got.to(torch.bfloat16))


def test_csd_matvec_wrapper_matches_jax():
    """The reference module's ``csd_matvec`` (its Pallas kernel on 128 x
    128 tiles, interpret mode) and the port's op given the same planes by
    name: bit for bit."""
    from repro.kernels.csd_matvec import csd_matvec as jcsd
    from repro_torch.kernels.csd_matvec import csd_matvec
    rng = np.random.default_rng(RNG_SEED)
    W = rng.integers(-255, 256, (16, 128))
    planes = to_csd_array(W)
    x = rng.integers(-128, 128, (128, 16)).astype(np.int32)
    want = np.asarray(jcsd(jnp.asarray(x), jnp.asarray(planes),
                           interpret=True))
    got = csd_matvec(_t(x), planes=planes, bm=128, bn=128,
                     interpret=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(csd_matvec(_t(x), w_int=W).numpy(), want)


def test_train_and_data_package_exports():
    import repro_torch.data as tdata
    import repro_torch.train as ttrain
    from repro_torch.data import pendigits
    from repro_torch.train import TrainConfig, train
    from repro_torch.train import zaal
    assert TrainConfig is zaal.TrainConfig and train is zaal.train
    assert tdata.pendigits is pendigits and ttrain.train is train
    assert pendigits.load is importlib.import_module(
        "repro_torch.data.pendigits").load
