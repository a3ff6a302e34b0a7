"""whisper-base — encoder-decoder, conv audio frontend STUBBED.

[arXiv:2212.04356; unverified]. 6L (enc) + 6L (dec) d_model=512 8H
d_ff=2048 vocab=51865. LayerNorm + non-gated GELU MLP + learned positions
(faithful to Whisper). input_specs() provides precomputed mel-frame
embeddings (B, S, d_model) for the encoder.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="whisper_base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    norm="layernorm",
    mlp_gated=False,
    pos="learned",
    input_kind="encdec",
    ot_loss_weight=0.1,
))
