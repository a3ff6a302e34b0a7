"""qwen2-1.5b — GQA with QKV bias. [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="qwen2_1p5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    ot_loss_weight=0.1,
))
