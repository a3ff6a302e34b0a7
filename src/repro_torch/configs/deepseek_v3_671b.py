"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8) + MTP.

[arXiv:2412.19437; hf]. 61L d_model=7168 128H, MLA kv_lora=512,
expert d_ff=2048, vocab=129280, first 3 layers dense (d_ff=18432),
multi-token-prediction auxiliary head. Sinkhorn-balanced router.
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="deepseek_v3_671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab=129280,
    attention="mla",
    kv_lora=512,
    q_lora=1536,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    router="sinkhorn",
    mtp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    zero3=True,
    ot_loss_weight=0.1,
))
