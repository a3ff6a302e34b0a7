"""smollm-135m — small llama-arch LM. [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152. Also serves as the
~100M end-to-end training example (examples/train_lm.py).
"""
from .base import ArchConfig, register

register(ArchConfig(
    name="smollm_135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    ot_loss_weight=0.1,
))
