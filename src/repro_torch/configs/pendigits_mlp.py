"""The paper's own five ANN structures (Section VII), as configs for the
repro_torch.core pipeline: 16-10, 16-10-10, 16-16-10, 16-10-10-10,
16-16-10-10 (counterpart of ``repro/configs/pendigits_mlp.py``)."""

STRUCTURES = [
    (16, 10),
    (16, 10, 10),
    (16, 16, 10),
    (16, 10, 10, 10),
    (16, 16, 10, 10),
]

def hw_activations(structure):
    """htanh hidden + hsig output (paper Section VII, ZAAL/PyTorch row)."""
    return tuple(["htanh"] * (len(structure) - 2) + ["hsig"])
