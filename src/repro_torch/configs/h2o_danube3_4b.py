"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]. 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000. SWA window 4096 — the only dense arch that RUNS
the long_500k cell (rolling KV cache of window size).
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="h2o_danube3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    window=4096,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    ot_loss_weight=0.1,
))
