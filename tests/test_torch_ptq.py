"""repro_torch.quant against the JAX package on the CPU: identical int
mantissas and exponents, exact int4 packing, exact dequantization."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")    # the oracle; the GPU machine has none
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import quantize_pot as jquantize_pot
from repro.nn import Model as JModel
from repro.nn import get_config as jget_config
from repro.quant import ptq as jptq
from repro_torch.kernels import quantize_pot
from repro_torch.nn import params_from_jax
from repro_torch.quant import ptq


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                              n_layers=2, dtype="float32")
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("bits", [8, 6, 4, "mixed"])
def test_quantize_tree_identical_to_jax(params, bits):
    """Same float weights in, the same q / exp / bits / packed out, leaf for
    leaf; the skipped leaves stay as they were."""
    jp, tp = params
    if bits == "mixed":
        bits = {"layers/attn/wq": 4, "layers/mlp/wd": 5, "lm_head": 6}
    jq = _flat(jax.tree.map(np.asarray, jptq.quantize_tree(jp, bits=bits)))
    tq = _flat(ptq.quantize_tree(tp, bits=bits))
    assert set(tq) == set(jq)
    for k, v in tq.items():
        if torch.is_tensor(v):
            np.testing.assert_array_equal(v.numpy(), jq[k], err_msg=k)
            assert v.numpy().dtype == np.asarray(jq[k]).dtype, k
        else:
            assert v == jq[k], k


@pytest.mark.parametrize("scale", [1e-3, 0.05, 1.0, 300.0])
def test_quantize_pot_identical_to_jax(scale):
    rng = np.random.default_rng(int(scale * 1000) % 97)
    w = (rng.normal(size=(3, 40, 24)) * scale).astype(np.float32)
    w[0, :, 0] = 0.0                                  # an all-zero channel
    for bits in (8, 4):
        jq, je = jquantize_pot(jnp.asarray(w), bits=bits, axis=(0, 1))
        tq, te = quantize_pot(_t(w), bits=bits, axis=(0, 1))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_pack_unpack_int4_round_trip_and_bits():
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, size=(3, 5, 16)).astype(np.int8)
    packed = ptq.pack_int4(_t(q))
    assert packed.dtype == torch.int8 and packed.shape == (3, 5, 8)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jptq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(ptq.unpack_int4(packed).numpy(), q)


def test_dequant_exact(params):
    """dequant is q * 2^-exp exactly (checked in float64), equal to the
    JAX dequant, in f32 and bf16; quant_bytes agrees with the reference."""
    jp, tp = params
    for bits in (8, 4):
        tq = ptq.quantize_tree(tp, bits=bits)
        jq = jptq.quantize_tree(jp, bits=bits)
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            td = _flat(ptq.dequant(tq, dtype=dtype))
            jd = _flat(jax.tree.map(np.asarray, jptq.dequant(jq, jdtype)))
            for k, v in td.items():
                np.testing.assert_array_equal(v.float().numpy(),
                                              np.asarray(jd[k], np.float32),
                                              err_msg=k)
        leaf = tq["layers"]["attn"]["wq"]
        q = ptq.unpack_int4(leaf["q"]) if leaf.get("packed") else leaf["q"]
        exact = q.numpy().astype(np.float64) * np.exp2(
            -leaf["exp"].numpy().astype(np.float64))
        got = ptq.dequant({"w": leaf}, dtype=torch.float32)["w"]
        np.testing.assert_array_equal(got.numpy().astype(np.float64), exact)
        assert ptq.quant_bytes(tq) == jptq.quant_bytes(jq)


def test_serving_quant_hook(params):
    _, tp = params
    qt, deq, nbytes = ptq.serving_quant(tp, bits=8, dtype=torch.bfloat16)
    assert nbytes == ptq.quant_bytes(qt) < ptq.quant_bytes(tp)
    w = deq(qt)["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16 and w.shape == tp["layers"]["attn"]["wq"].shape
    assert deq(qt)["layers"]["mlp"]["wu"].dtype == torch.float32   # skipped
