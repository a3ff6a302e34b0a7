"""internvl2-26b — InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]. 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The vision frontend is a stub: input_specs() provides
precomputed patch embeddings (B, S, d_model) per the assignment.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="internvl2_26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    rope_theta=1_000_000.0,
    input_kind="embeds",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    zero3=True,
    ot_loss_weight=0.1,
))
