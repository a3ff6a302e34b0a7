"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]. 38L d_model=2048, shared attn 32H (MHA, head 64),
d_ff=8192 (in the shared block's MLP), vocab=32000, ssm_state=64.
Every 6th layer applies the SINGLE shared attention+MLP block (weight
reuse, as in the Zamba line; per-use LoRA adapters omitted — the JAX package's design notes).
long_500k RUNS: mamba state is O(1)/token; the shared attention uses a
rolling window (long_context_window) at 500k — documented deviation.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="zamba2_1p2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    long_context_window=4096,
    ot_loss_weight=0.1,
))
