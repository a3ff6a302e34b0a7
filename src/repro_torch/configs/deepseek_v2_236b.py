"""deepseek-v2-236b — MLA + MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf]. 60L d_model=5120 128H, MLA kv_lora=512,
expert d_ff=1536, vocab=102400, first layer dense (d_ff=12288).
Router: the paper-integrated Sinkhorn-balanced assignment (models.ot_loss).
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="deepseek_v2_236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,
    vocab=102400,
    attention="mla",
    kv_lora=512,
    q_lora=1536,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    router="sinkhorn",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    zero3=True,
    ot_loss_weight=0.1,
))
