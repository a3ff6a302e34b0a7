"""deepseek-7b — llama-architecture dense LM. [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008 vocab=102400.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    ot_loss_weight=0.1,
))
