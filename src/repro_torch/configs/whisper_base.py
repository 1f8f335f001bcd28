"""whisper-base [audio]: encoder-decoder over stub frame embeddings.
[arXiv:2212.04356]

The convolutional front end is a stub: the encoder takes precomputed
frame embeddings (B, 1500, 512), 30 s of audio.  6 encoder layers of
non-causal self-attention and 6 decoder layers of causal self-attention,
cross-attention to the encoder output and an MLP; 8 / 8 heads of 64.
"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    is_encdec=True, n_enc_layers=6, n_frames=1500,
))
