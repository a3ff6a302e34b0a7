"""Architecture config schema and registry of the ten architectures.

Counterpart of ``repro.configs.base``: the same records field for field
(each architecture's module registers one), so ``list_archs()`` and
``get_config(name)`` are the JAX package's. ``dtype`` / ``cdtype`` give
torch dtypes. The port runs every family of the registry
(``repro_torch.models``): ``dense``, ``vlm``, ``moe``, ``ssm``,
``hybrid`` and ``encdec``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

import torch

__all__ = ["ArchConfig", "register", "get_config", "list_archs",
           "torch_dtype"]

_REGISTRY: Dict[str, "ArchConfig"] = {}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``,
    ``"bfloat16"``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    window: Optional[int] = None              # sliding-window attention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"                     # rmsnorm | layernorm
    mlp_gated: bool = True
    pos: str = "rope"                         # rope | learned
    tie_embeddings: bool = False

    attention: str = "gqa"                    # gqa | mla | none
    # MLA dims (DeepSeek-V2/V3)
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    router: str = "softmax"                   # softmax | sinkhorn
    capacity_factor: float = 1.25

    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    attn_every: int = 0                       # hybrid: shared attn block cadence

    # enc-dec
    n_enc_layers: int = 0

    input_kind: str = "tokens"                # tokens | embeds | encdec
    mtp: bool = False                         # multi-token prediction head

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    zero3: bool = False                       # FSDP params over data axis

    # the paper's technique as an auxiliary LM loss (models.ot_loss)
    ot_loss_weight: float = 0.0
    ot_features: int = 256                    # r — positive random features
    ot_protos: int = 512                      # prototype cloud size
    ot_dim: int = 16                          # f_gamma latent dim
    # eps scaled to the f_gamma ball (radius 2): diameter^2/eps = 8 keeps
    # the RF kernel well inside f32 range and above the kappa floor (the
    # Lemma-1 feature count needed explodes when eps << diam^2, Thm 3.1)
    ot_eps: float = 2.0
    ot_tokens: int = 512                      # tokens subsampled per device
    ot_iters: int = 30
    # execution policy for EVERY training-time OT solve (prototype loss,
    # sinkhorn router, GAN objective) — consumed once per run via
    # ExecutionPolicy.from_config (core.objective)
    ot_precision: str = "bf16"                # "highest" | "bf16" factors
    ot_use_pallas: Optional[bool] = None      # None=auto fused plan policy
    ot_inner_steps: Optional[int] = None      # megakernel cadence (None=auto)
    ot_check_every: Optional[int] = None      # convergence-check cadence
    ot_backend: Optional[str] = None          # the JAX package's backend pin
    # shard training-time OT solves over the step's mesh (psum'd-LSE
    # operators). None = auto: shard exactly when the mesh spans more
    # than one device; single-device meshes keep the local (fused-plan
    # capable) solvers — a mesh-wrapped policy would disable them.
    ot_shard: Optional[bool] = None

    # long-context serving: rolling attention window override (hybrids)
    long_context_window: Optional[int] = None

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_plan(self) -> List[str]:
        """Per-layer block kinds for the decoder stack."""
        plan: List[str] = []
        if self.family == "encdec":
            return ["dec_attn"] * self.n_layers
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid":
            for i in range(self.n_layers):
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    plan.append("shared_attn")
                else:
                    plan.append("mamba")
            return plan
        attn = "mla" if self.attention == "mla" else "attn"
        for i in range(self.n_layers):
            if self.n_experts and i >= self.first_k_dense:
                plan.append(f"{attn}_moe")
            else:
                plan.append(attn)
        return plan

    def supports_decode(self) -> bool:
        return True   # none of the assigned archs are encoder-only

    def supports_long_context(self) -> bool:
        """Sub-quadratic serving path exists (SSM/hybrid/SWA)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.window is not None
        )

    def tiny(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            kv_lora=32,
            q_lora=64,
            qk_nope=32,
            qk_rope=16,
            v_head=32,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=32 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_every=3 if self.attn_every else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            window=min(self.window, 64) if self.window else None,
            ot_features=32,
            ot_protos=64,
            ot_dim=8,
            ot_tokens=64,
            ot_iters=10,
        )
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


_ARCH_MODULES = [
    "internvl2_26b",
    "h2o_danube3_4b",
    "deepseek_7b",
    "qwen2_1p5b",
    "smollm_135m",
    "whisper_base",
    "zamba2_1p2b",
    "deepseek_v2_236b",
    "deepseek_v3_671b",
    "mamba2_1p3b",
]

_CANON = {
    "internvl2-26b": "internvl2_26b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "deepseek-7b": "deepseek_7b",
    "qwen2-1.5b": "qwen2_1p5b",
    "smollm-135m": "smollm_135m",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-1.3b": "mamba2_1p3b",
}


def _load_all():
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    _load_all()
    key = _CANON.get(name, name).replace("-", "_")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)
