"""repro_torch's ``launch/specs.py`` against the JAX package's on the CPU:
for every config of ``list_configs()`` and every shape of
``applicable_shapes(cfg)``, the port's ``input_specs`` (the shape's own
kind, and with and without labels), ``cache_struct`` and
``param_structs`` give the same tree of shapes and dtypes as the
reference's ``ShapeDtypeStruct``s, and every leaf is a meta tensor, so
nothing is allocated -- arctic-480b's 480 B parameters included."""
import pytest
import torch

try:    # the JAX package is the oracle
    import jax
    from repro.launch import specs as jspecs
    from repro.nn import get_config as jget_config
    from repro.nn.types import SHAPES as JSHAPES
except ImportError:
    jax = None
from repro_torch.launch import specs
from repro_torch.nn import get_config
from repro_torch.nn.types import SHAPES, applicable_shapes, list_configs

CELLS = [(arch, shape.name) for arch in list_configs()
         for shape in applicable_shapes(get_config(arch))]


def _layout(tree):
    """The tree's structure with each leaf as (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _meta_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _meta_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _meta_leaves(v)]
    return [tree]


def _assert_same(got, want):
    assert _layout(got) == _layout(want)
    leaves = _meta_leaves(got)
    assert leaves and all(isinstance(t, torch.Tensor) and t.is_meta
                          for t in leaves)


def _cell(arch, shape_name):
    return (jget_config(arch), JSHAPES[shape_name], get_config(arch),
            SHAPES[shape_name])


@pytest.mark.parametrize("with_labels", [None, True, False],
                         ids=["kind", "labels", "no-labels"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape, with_labels):
    """The batch of the cell: decode's (B, 1) tokens, a VLM's patches and
    ``seq_len - n_patches`` tokens, audio's frames beside ``seq_len``
    tokens, labels where asked (by default for a train shape)."""
    jcfg, jshape, cfg, tshape = _cell(arch, shape)
    got = specs.input_specs(cfg, tshape, with_labels=with_labels)
    _assert_same(got, jspecs.input_specs(jcfg, jshape,
                                         with_labels=with_labels))
    if cfg.family == "audio" and tshape.kind != "decode":
        assert got["frames"].shape == (tshape.global_batch, 1500, 512)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cache_struct_matches_reference(arch, shape):
    """The decode cache of the cell, ``Model.init_cache``'s tree: K/V,
    audio's cross leaves, RWKV6's fixed-size states, the hybrid's rings
    and recurrent states."""
    jcfg, jshape, cfg, tshape = _cell(arch, shape)
    _assert_same(specs.cache_struct(cfg, tshape),
                 jspecs.cache_struct(jcfg, jshape))


@pytest.mark.parametrize("arch", list_configs())
def test_param_structs_match_reference(arch):
    """``Model.init``'s tree (the reference's by ``jax.eval_shape``), with
    ``Model(cfg, device="meta").init`` drawing nothing."""
    cfg = get_config(arch)
    _assert_same(specs.param_structs(cfg),
                 jspecs.param_structs(jget_config(arch)))
