"""mamba2-1.3b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]. 48L d_model=2048, d_ff=0 (mixer-only
blocks), vocab=50280, ssm_state=128. long_500k RUNS (O(1) decode state).
The paper's attention-free family: the OT technique attaches as the
representation loss only (the JAX package's design notes).
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="mamba2_1p3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    ot_loss_weight=0.1,
))
