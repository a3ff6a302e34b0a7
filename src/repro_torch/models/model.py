"""Model assembly: configs -> init / forward / loss / prefill / decode, for
the ``dense``, ``vlm``, ``moe``, ``ssm``, ``hybrid`` and ``encdec``
families.

The layer plan (``configs.base.ArchConfig.layer_plan``) is grouped into
runs of one block kind; each run's parameters are stacked on a leading
layer axis, as the JAX package stacks them for its ``lax.scan``, so the
two packages' parameters line up leaf for leaf and AdamW's weight-decay
mask (every leaf of more than one dimension) decays a group's norm scales
and biases as the reference does. The forward unbinds each stacked leaf
once and runs the layers in order, each under
``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` is set.

Block kinds: ``attn`` (GQA), ``mla`` (multi-head latent attention) and
their ``_moe`` twins, whose FFN half is the mixture of experts
(``models.moe``, the Sinkhorn router for the DeepSeek configs) plus the
shared experts' MLP; ``mamba`` (a Mamba2 mixer, ``models.ssm``, with no
FFN half); and the hybrid's ``shared_attn``: one ``attn`` block whose
parameters are held once, in ``params["shared_attn"]``, applied at every
``attn_every``-th layer outside remat (its gradient the sum over its
uses), each use with its own unstacked GQA cache; and the
encoder-decoder's ``enc_attn`` (bidirectional self-attention, the
encoder's blocks, stacked in ``params["encoder"]``) and ``dec_attn``
(causal self-attention, then cross-attention over the encoder's output,
``norm_x`` and ``xattn``). A ``shared_attn`` group
holds the empty dict in ``params["groups"]`` where the reference holds
``None`` (a leaf in ``torch.utils._pytree``, so ``convert.lm_params``
maps the one to the other): the two packages' leaf names
(``groups/2/mixer/in_proj/w``, ``shared_attn/attn/wq/w``) agree and
AdamW and the checkpoints see no placeholder.
The MoE layers' auxiliary losses are summed over the layers into ``aux``;
with ``cfg.mtp`` one more block on the final hidden states predicts the
token after the next (the multi-token-prediction loss).

On a mesh (a current ``distributed.sharding.MeshContext`` with a
``"model"`` axis, one rank included, as the reference's train step always
enters one) training and prefill take the reference's activation layout:
each rank holds its block of the batch, its rows and, where the context
splits the sequence over ``"model"`` (``distributed.seq_axis``), the
contiguous S / tp segment of each row, from the embedding to the final
norm. Norms, MLPs and projections are per token; the attention gathers K
and V over ``"model"`` (MLA its latents) and masks by global positions;
learned positions and RoPE are offset by the segment's first position;
the MoE layers run expert parallel on the rank's tokens
(``models.moe.moe_ep_local``, with its capacity drops) and the SSD
context parallel (``models.ssm``, the conv's halo from the previous
rank); the MTP loss pairs a rank's last position with the next rank's
first label. With ``specs`` (the parameters' specs) the parameters are
the rank's shards, each gathered whole where it is used, a stacked
group's a layer at a time. Decode runs the dense experts, as the
reference's does, on the whole batch's tokens (gathered over the data
axes, so the Sinkhorn router balances the batch a card would); without a
context the experts run dense. :func:`cache_logical_axes` names the
caches' logical axes and :func:`shard_caches` cuts a rank's batch rows.

Learned positions (``cfg.pos == "learned"``) are one (65536, d) table in
``params["pos"]``, shared by the encoder and the decoder; decode reads the
row of ``caches[0].length`` on the device, clamped to the table.
Parameters are a nested dict of tensors (``tree.named_leaves`` names
them). The OT prototype loss (``models.ot_loss``) is part of
:func:`train_loss` whenever ``cfg.ot_loss_weight > 0``. Counterpart of
``repro.models.model``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.objective import ExecutionPolicy
from ..core.sinkhorn import is_dry
from ..distributed.sharding import MeshAxis, MeshContext, PartitionSpec, \
    all_gather, current_mesh_context, gather_spec, pmean, resolve_logical, \
    rows_axis, seq_axis, use_mesh_context
from ..tree import named_leaves, tree_leaves, tree_unflatten
from .attention import (
    GQACache,
    MLACache,
    cross_attend_step,
    cross_attention,
    gqa_attend_step,
    gqa_train,
    init_cross_attention,
    init_gqa,
    init_gqa_cache,
    init_mla,
    init_mla_cache,
    mla_attend_step,
    mla_train,
)
from .layers import (
    init_device,
    init_embedding,
    init_linear,
    init_mlp,
    layernorm,
    linear,
    mlp,
    rmsnorm,
    trunc_normal,
)
from .moe import init_moe, moe_dense, moe_ep_local
from .ot_loss import init_ot_loss, ot_prototype_loss
from .ssm import Mamba2Cache, init_mamba2, init_mamba2_cache, \
    mamba2_decode, mamba2_train

__all__ = [
    "check_ported",
    "init_params",
    "forward",
    "train_loss",
    "prefill",
    "decode_step",
    "init_caches",
    "group_plan",
    "effective_window",
    "param_count",
    "cache_logical_axes",
    "shard_caches",
]

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
POS_ROWS = 65536                # rows of the learned position table

Cache = Union[GQACache, MLACache, Mamba2Cache]


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config of a family the port
    does not know."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no family {cfg.family!r}; the port has "
            f"{PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def _init_norm(cfg: ArchConfig, device, lead=()) -> Dict[str, torch.Tensor]:
    shape = lead + (cfg.d_model,)
    p = {"w": torch.ones(shape, dtype=cfg.dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return p


def group_plan(plan: List[str]) -> List[Tuple[str, int]]:
    groups: List[Tuple[str, int]] = []
    for kind in plan:
        if groups and groups[-1][0] == kind and kind != "shared_attn":
            groups[-1] = (kind, groups[-1][1] + 1)
        else:
            groups.append((kind, 1))
    return groups


def effective_window(cfg: ArchConfig, s_max: int) -> Optional[int]:
    if cfg.window is not None:
        return cfg.window
    if cfg.long_context_window is not None and s_max > 65536:
        return cfg.long_context_window
    return None


def _unstack(stack: Any, count: int) -> List[Any]:
    """The per-layer trees of a stacked group: each leaf unbound once, so
    the backward stacks the layers' gradients in one allocation."""
    columns = [leaf.unbind(0) for leaf in tree_leaves(stack)]
    return [tree_unflatten(stack, [c[i] for c in columns])
            for i in range(count)]


_EXPERTS = ("moe/up", "moe/gate", "moe/down")


def _whole(tree: Any, specs: Any) -> Any:
    """The leaves of ``tree`` gathered whole from this rank's shards by
    ``specs`` (a tree of :class:`PartitionSpec` of the same structure)
    under the current mesh context, differentiably (the backward
    reduce-scatters each leaf's gradient to the shards); the experts stay
    the rank's own. ``specs=None``: ``tree`` as it is."""
    if specs is None:
        return tree
    ctx = current_mesh_context()
    return tree_unflatten(tree, [
        t if name.endswith(_EXPERTS) else gather_spec(t, spec, ctx)
        for (name, t), spec in zip(named_leaves(tree), tree_leaves(specs))])


def _part(params, specs, key: str) -> Any:
    """``params[key]`` gathered whole where it is used."""
    return _whole(params[key], None if specs is None else specs[key])


def _layers(stack: Any, specs: Any, count: int) -> List[Tuple[Any, Any]]:
    """The per-layer (shards, specs) of a stacked group. A leaf whose
    layer axis is sharded (the MoE router's over ``"model"``, a norm
    stack's over the data axes) is gathered whole along it first, as one
    small stack; every other leaf is gathered a layer at a time, where
    the layer runs."""
    if specs is None:
        return [(p, None) for p in _unstack(stack, count)]
    ctx = current_mesh_context()
    leaves, layer_specs = [], []
    for t, spec in zip(tree_leaves(stack), tree_leaves(specs)):
        if spec and spec[0] is not None:
            t = gather_spec(t, spec[:1], ctx)
        leaves.append(t)
        layer_specs.append(PartitionSpec(*spec[1:]))
    per_layer = tree_unflatten(specs, layer_specs)
    return [(p, per_layer) for p in _unstack(
        tree_unflatten(stack, leaves), count)]


# ---------------------------------------------------------------------------
# per-block init / train / decode
# ---------------------------------------------------------------------------


def _is_mla(kind: str) -> bool:
    return kind in ("mla", "mla_moe")


def _mtp_kind(cfg: ArchConfig) -> str:
    return "mla" if cfg.attention == "mla" else "attn"


def _ssm_kw(cfg: ArchConfig) -> Dict[str, int]:
    return dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand)


def _init_block(generator, kind: str, cfg: ArchConfig, device,
                lead=()) -> Dict:
    kw = dict(dtype=cfg.dtype, device=device, lead=lead)
    p: Dict[str, Any] = {"norm1": _init_norm(cfg, device, lead)}
    if kind == "mamba":
        p["mixer"] = init_mamba2(generator, cfg.d_model,
                                 conv_kernel=cfg.conv_kernel, **_ssm_kw(cfg),
                                 **kw)
        return p
    if _is_mla(kind):
        p["attn"] = init_mla(generator, cfg.d_model, cfg.n_heads,
                             kv_lora=cfg.kv_lora, q_lora=cfg.q_lora,
                             qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                             v_head=cfg.v_head, **kw)
    else:
        p["attn"] = init_gqa(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim,
                             qkv_bias=cfg.qkv_bias, **kw)
    if kind == "dec_attn":
        p["norm_x"] = _init_norm(cfg, device, lead)
        p["xattn"] = init_cross_attention(generator, cfg.d_model,
                                          cfg.n_heads, cfg.head_dim, **kw)
    if kind.endswith("_moe"):
        p["norm2"] = _init_norm(cfg, device, lead)
        p["moe"] = init_moe(generator, cfg.d_model, cfg.moe_d_ff,
                            cfg.n_experts, **kw)
        if cfg.n_shared_experts:
            p["shared_mlp"] = init_mlp(
                generator, cfg.d_model, cfg.n_shared_experts * cfg.moe_d_ff,
                gated=cfg.mlp_gated, **kw)
    elif cfg.d_ff:
        p["norm2"] = _init_norm(cfg, device, lead)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                            gated=cfg.mlp_gated, **kw)
    return p


def _local_experts(pm, cfg: ArchConfig, tp: MeshAxis,
                   fsdp: Optional[MeshAxis]) -> Dict[str, torch.Tensor]:
    """The router and this rank's expert stacks, from whole stacks or from
    the rank's own (a train step hands over its shards): E cut over
    ``tp``, and d over ``fsdp`` where the experts gather lazily."""
    out = dict(pm)
    for k, d_dim in (("up", 1), ("gate", 1), ("down", 2)):
        w = out[k]
        if w.shape[0] == cfg.n_experts and tp.size > 1:
            e = cfg.n_experts // tp.size
            w = w[tp.rank * e:(tp.rank + 1) * e]
        if fsdp is not None and fsdp.size > 1 and \
                w.shape[d_dim] == cfg.d_model:
            n = cfg.d_model // fsdp.size
            w = w.narrow(d_dim, fsdp.rank * n, n)
        out[k] = w
    return out


def _moe_apply(p, x2: torch.Tensor, cfg: ArchConfig, *,
               decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 (B, S, d) normed input -> (out, aux): expert parallel under a
    mesh context with a ``"model"`` axis, dense otherwise and in decode;
    the router under the config's OT policy."""
    B, S, d = x2.shape
    policy = ExecutionPolicy.from_config(cfg)
    ctx = current_mesh_context()
    if decode or ctx is None or ctx.tp_axis is None:
        x_all = x2.reshape(-1, d)
        # a decode step's router sees the whole batch, as on one card (the
        # Sinkhorn router balances the tokens it is given)
        split = decode and rows_axis(ctx) is not None
        if split:
            x_all = all_gather(x_all, ctx.dp, dim=0)
        out, aux = moe_dense(p["moe"], x_all, top_k=cfg.top_k,
                             router=cfg.router, policy=policy)
        if split:
            out = out[ctx.dp.rank * B * S:(ctx.dp.rank + 1) * B * S]
        return out.reshape(B, S, d), aux
    tp = ctx.axis(ctx.tp_axis)
    fsdp = ctx.dp if (cfg.zero3 and ctx.dp_axes) else None
    if tp.size > 1 and seq_axis(ctx) is None:
        raise ValueError(f"a sequence of {S} not split over {tp.size} "
                         "'model' ranks")
    # x2 is the rank's block: the reference's tokens of this rank under
    # P(dp, tp, None), the segment of each of its rows, in (b, s) order
    out, aux = moe_ep_local(
        _local_experts(p["moe"], cfg, tp, fsdp), x2.reshape(-1, d),
        top_k=cfg.top_k, n_experts=cfg.n_experts, axis=tp,
        router=cfg.router, capacity_factor=cfg.capacity_factor,
        fsdp_axis=fsdp, policy=policy)
    if ctx.dp_axes:
        aux = pmean(aux, ctx.dp)
    return out.reshape(B, S, d), aux


def _ffn(p, x: torch.Tensor, cfg: ArchConfig, *, decode: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN half of a block: ``(x + ffn(norm2(x)), aux)``, aux 0-d
    float32 (0 outside the MoE)."""
    if "moe" in p:
        x2 = _norm(p["norm2"], x, cfg)
        out, aux = _moe_apply(p, x2, cfg, decode=decode)
        if "shared_mlp" in p:
            out = out + mlp(p["shared_mlp"], x2, gated=cfg.mlp_gated)
        return x + out, aux
    if "mlp" in p:
        x = x + mlp(p["mlp"], _norm(p["norm2"], x, cfg), gated=cfg.mlp_gated)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _block_train(kind: str, p, x: torch.Tensor, cfg: ArchConfig,
                 enc: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(x_out, aux)``, aux 0-d float32 (0 outside the MoE);
    ``enc`` is the encoder's output, which a ``dec_attn`` block attends.
    Under a context that splits the sequence, x and enc are this rank's
    segments: the attention gathers K and V over ``"model"``."""
    h = _norm(p["norm1"], x, cfg)
    sq = seq_axis()
    if kind == "mamba":
        return (x + mamba2_train(p["mixer"], h, chunk=cfg.ssm_chunk,
                                 **_ssm_kw(cfg)),
                torch.zeros((), dtype=torch.float32, device=x.device))
    if _is_mla(kind):
        x = x + mla_train(p["attn"], h, n_heads=cfg.n_heads,
                          kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
                          qk_rope=cfg.qk_rope, v_head=cfg.v_head,
                          rope_theta=cfg.rope_theta, seq_axis=sq)
    elif kind == "enc_attn":
        # bidirectional: the cross-attention's math on the states themselves
        x = x + cross_attention(p["attn"], h, h, n_heads=cfg.n_heads,
                                head_dim=cfg.head_dim, seq_axis=sq)
    else:
        x = x + gqa_train(p["attn"], h, n_heads=cfg.n_heads,
                          n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                          rope_theta=cfg.rope_theta, window=cfg.window,
                          seq_axis=sq)
    if kind == "dec_attn":
        x = x + cross_attention(p["xattn"], _norm(p["norm_x"], x, cfg), enc,
                                n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                seq_axis=sq)
    return _ffn(p, x, cfg)


def _block_decode(kind: str, p, x: torch.Tensor, cache: Cache, layer: int,
                  cfg: ArchConfig, window: Optional[int], enc_kv=None):
    """One token through layer ``layer`` of a group; the group's cache is
    read only. Returns ``(x, new)``: the new token's (k, v) or (c_kv,
    k_rope) slot, or the layer's new (conv history, SSM state). A
    ``dec_attn`` layer attends ``enc_kv``'s (k, v) of its layer, each
    (L, B, T, H, D)."""
    h = _norm(p["norm1"], x, cfg)
    if kind == "mamba":
        out, new = mamba2_decode(
            p["mixer"], h, Mamba2Cache(cache.conv[layer], cache.state[layer],
                                       cache.length[layer]), **_ssm_kw(cfg))
        return x + out, new[:2]
    if _is_mla(kind):
        out, *new = mla_attend_step(
            p["attn"], h, cache.c_kv[layer], cache.k_rope[layer],
            cache.length[layer], n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
            qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_head=cfg.v_head,
            rope_theta=cfg.rope_theta)
    else:
        out, *new = gqa_attend_step(
            p["attn"], h, cache.k[layer], cache.v[layer],
            cache.length[layer], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=window)
    x = x + out
    if kind == "dec_attn":
        x = x + cross_attend_step(p["xattn"], _norm(p["norm_x"], x, cfg),
                                  enc_kv["k"][layer], enc_kv["v"][layer],
                                  n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    x, _ = _ffn(p, x, cfg, decode=True)
    return x, new


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Seeded random parameters (truncated normals, unit norms, zero
    biases) on ``device`` (default: the card; ``"meta"`` for shapes only),
    drawn from ``generator`` (default: a CPU generator seeded with
    ``seed``). The weights are not the JAX package's (``convert.lm_params``
    carries those across); their distributions are."""
    check_ported(cfg)
    dev = init_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(int(seed))
    params: Dict[str, Any] = {}
    if cfg.input_kind in ("tokens", "encdec"):
        params["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype=cfg.dtype, device=dev)
    if cfg.pos == "learned":
        params["pos"] = trunc_normal((POS_ROWS, cfg.d_model), 0.01,
                                     generator=gen, dtype=cfg.dtype,
                                     device=dev)
    groups = []
    for kind, count in group_plan(cfg.layer_plan()):
        if kind == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = _init_block(gen, "attn", cfg, dev)
            groups.append({})
        else:
            groups.append(_init_block(gen, kind, cfg, dev, lead=(count,)))
    params["groups"] = groups
    if cfg.family == "encdec":
        params["encoder"] = _init_block(gen, "enc_attn", cfg, dev,
                                        lead=(cfg.n_enc_layers,))
        params["enc_norm"] = _init_norm(cfg, dev)
    params["final_norm"] = _init_norm(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                        dtype=cfg.dtype, device=dev)
    if cfg.mtp:
        params["mtp_block"] = _init_block(gen, _mtp_kind(cfg), cfg, dev)
        params["mtp_norm"] = _init_norm(cfg, dev)
    if cfg.ot_loss_weight > 0:
        params["ot"] = init_ot_loss(
            gen, cfg.d_model, ot_dim=cfg.ot_dim, n_protos=cfg.ot_protos,
            n_features=cfg.ot_features, eps=cfg.ot_eps, device=dev)
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _add_positions(params, cfg: ArchConfig, x: torch.Tensor,
                   specs=None) -> torch.Tensor:
    """x (B, S, d) plus the learned positions 0..S-1 (where the config has
    them), offset by the segment's first position on a sequence split
    over ``"model"``."""
    if cfg.pos != "learned":
        return x
    S = x.shape[1]
    sq = seq_axis()
    lo = 0 if sq is None else sq.rank * S
    table = _part(params, specs, "pos")
    return x + table[lo:lo + S][None].to(cfg.cdtype)


def _embed_inputs(params, cfg: ArchConfig, batch: Dict,
                  specs=None) -> torch.Tensor:
    if cfg.input_kind == "embeds":
        x = batch["embeds"].to(cfg.cdtype)
    else:
        table = _part(params, specs, "embed")["table"]
        x = table.to(cfg.cdtype)[batch["tokens"]]
    return _add_positions(params, cfg, x, specs)


def _run_layer(kind: str, p_l, x: torch.Tensor, cfg: ArchConfig,
               enc: Optional[torch.Tensor], remat: bool, specs=None):
    """One layer of a stacked group, under ``torch.utils.checkpoint`` with
    ``remat``: the layer's leaves and ``enc`` are arguments of the
    checkpoint, so their gradients flow through the recomputation, which
    runs under the mesh context of the forward (expert and context
    parallel where it was), wherever the backward is called. With
    ``specs`` the leaves are the rank's shards, gathered whole inside the
    checkpoint's body: the recomputation gathers them again, so one layer
    is whole at a time."""
    if not remat:
        return _block_train(kind, _whole(p_l, specs), x, cfg, enc)
    leaves = tree_leaves(p_l)
    ctx = current_mesh_context()

    def body(x_, enc_, *ls):
        with use_mesh_context(ctx):
            return _block_train(kind, _whole(tree_unflatten(p_l, list(ls)),
                                             specs), x_, cfg, enc_)

    # a dry run's recomputation makes new symbols for the sizes that depend
    # on the data (EP's kept rows), which the check cannot compare
    return checkpoint(body, x, enc, *leaves, use_reentrant=False,
                      determinism_check="none" if is_dry(x) else "default")


def _run_decoder_groups(params, cfg: ArchConfig, x: torch.Tensor,
                        enc: Optional[torch.Tensor] = None, specs=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers in order; returns ``(x, aux summed over the layers)``."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = None
    groups = [None] * len(params["groups"]) if specs is None \
        else specs["groups"]
    for (kind, count), stack, g_specs in zip(group_plan(cfg.layer_plan()),
                                             params["groups"], groups):
        if kind == "shared_attn":
            if shared is None:          # gathered once for all its uses
                shared = _part(params, specs, "shared_attn")
            x, aux_l = _block_train("attn", shared, x, cfg)
            aux = aux + aux_l
            continue
        for p_l, s_l in _layers(stack, g_specs, count):
            x, aux_l = _run_layer(kind, p_l, x, cfg, enc, remat, s_l)
            aux = aux + aux_l
    return x, aux


def _encode(params, cfg: ArchConfig, batch: Dict, specs=None) -> torch.Tensor:
    """The encoder: ``enc_embeds`` (B, T, d) plus positions 0..T-1 through
    the ``enc_attn`` layers, then ``enc_norm``. (B, T, d)."""
    remat = cfg.remat and torch.is_grad_enabled()
    x = _add_positions(params, cfg, batch["enc_embeds"].to(cfg.cdtype),
                       specs)
    for p_l, s_l in _layers(params["encoder"],
                            None if specs is None else specs["encoder"],
                            cfg.n_enc_layers):
        x, _ = _run_layer("enc_attn", p_l, x, cfg, None, remat, s_l)
    return _norm(_part(params, specs, "enc_norm"), x, cfg)


def forward(params, cfg: ArchConfig, batch: Dict,
            specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, d) after the final norm, the MoE layers'
    aux losses summed). An ``encdec`` config runs its encoder on
    ``batch["enc_embeds"]`` first. With ``specs`` (the parameters'
    :class:`PartitionSpec` tree, under a mesh context) ``params`` are
    this rank's shards, each gathered whole where it is used: a stacked
    group's a layer at a time, inside the layer's checkpoint."""
    check_ported(cfg)
    enc = _encode(params, cfg, batch, specs) if cfg.family == "encdec" \
        else None
    x = _embed_inputs(params, cfg, batch, specs)
    x, aux = _run_decoder_groups(params, cfg, x, enc, specs)
    return _norm(_part(params, specs, "final_norm"), x, cfg), aux


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return linear(params["lm_head"], h)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold)


def _head_weight(params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


_XENT_CHUNKS = 16


def _xent_chunk(h, wc, labels, m, s, gold, lo: int, V: int):
    chunk = wc.shape[1]
    logits = (h @ wc.to(h.dtype)).float()                 # (B, S, chunk)
    col = lo + torch.arange(chunk, device=h.device)
    # the padded tail of the last chunk must not contribute
    logits = torch.where((col < V)[None, None, :], logits, -1e30)
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    s = s * torch.exp(m - m_new) + torch.sum(
        torch.exp(logits - m_new[..., None]), dim=-1)
    local = torch.clamp(labels - lo, 0, chunk - 1)
    gold_c = torch.gather(logits, -1, local[..., None])[..., 0]
    in_chunk = (labels >= lo) & (labels < lo + chunk)
    return m_new, s, torch.where(in_chunk, gold_c, gold)


def _xent_chunked(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  n_chunks: int = _XENT_CHUNKS) -> torch.Tensor:
    """Streaming cross-entropy over vocab chunks: the (B, S, V) logits are
    never built, and each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), so the peak is O(V / n_chunks)."""
    B, S, _ = h.shape
    V = w.shape[1]
    chunk = -(-V // n_chunks)
    pad = n_chunks * chunk - V
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    gold = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    for i in range(n_chunks):
        wc = w[:, i * chunk:(i + 1) * chunk]
        if remat:
            m, s, gold = checkpoint(_xent_chunk, h, wc, labels, m, s, gold,
                                    i * chunk, V, use_reentrant=False)
        else:
            m, s, gold = _xent_chunk(h, wc, labels, m, s, gold, i * chunk, V)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    return torch.mean(lse - gold)


def _lm_ce(params, cfg: ArchConfig, h: torch.Tensor,
           labels: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab >= 32768:
        return _xent_chunked(h, _head_weight(params, cfg), labels)
    return _xent(_logits(params, cfg, h), labels)


def _head(params, cfg: ArchConfig, specs=None) -> Dict:
    """The parameters the logits read (the embedding or the LM head),
    gathered whole."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    return {key: _part(params, specs, key)}


def _mtp_ce(head, cfg: ArchConfig, hm: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The multi-token-prediction loss: position t against label t + 1,
    the mean over the B (S - 1) pairs. On a sequence split over
    ``"model"`` a rank's last position pairs with the next rank's first
    label and the last rank drops its last position, so the ranks hold
    unequal counts: each rank's mean is weighted by its pairs' share
    times the ``"model"`` ranks, and the ranks' mean is the reference's."""
    tp = seq_axis()
    if tp is None:
        return _lm_ce(head, cfg, hm[:, :-1], labels[:, 1:])
    S = hm.shape[1]
    # every rank's first label (not differentiable), and the next rank's
    firsts = tp.gather_rows(labels[:, :1].T.contiguous())      # (tp, B)
    nxt = firsts[(tp.rank + 1) % tp.size][:, None]
    n = S - 1 if tp.rank == tp.size - 1 else S
    lab = torch.cat([labels[:, 1:], nxt], dim=1)[:, :n]
    mean = _lm_ce(head, cfg, hm[:, :n], lab)
    return mean * (n * tp.size / (S * tp.size - 1))


def train_loss(params, cfg: ArchConfig, batch: Dict,
               policy: Optional[ExecutionPolicy] = None, *, specs=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training objective: cross-entropy, plus 0.01 times the MoE
    layers' aux loss, 0.3 times the multi-token-prediction loss where
    ``cfg.mtp`` (the MTP block on the final hidden states predicts the
    token after the next) and ``ot_loss_weight`` times the OT prototype
    loss. ``policy`` is the run-wide OT execution policy (``None``:
    ``ExecutionPolicy.from_config(cfg)``; its mesh, where it has one,
    shards the OT loss's solves). Under a mesh context each rank holds
    its block of the batch (its rows, its segment of the sequence where
    the context splits it), and the losses are this rank's share (``ce``
    over its tokens, ``mtp`` weighted by its pairs; ``aux`` and ``ot``
    global): the mean of the ranks' losses is the reference's. With
    ``specs`` ``params`` are the rank's shards (:func:`forward`). Returns
    ``(loss, {"ce", "aux"[, "mtp"][, "ot"], "loss"})``, 0-d tensors."""
    if policy is None:
        policy = ExecutionPolicy.from_config(cfg)
    h, aux = forward(params, cfg, batch, specs)
    head = _head(params, cfg, specs)
    loss_ce = _lm_ce(head, cfg, h, batch["labels"])
    metrics = {"ce": loss_ce, "aux": aux}
    loss = loss_ce + 0.01 * aux
    if cfg.mtp:
        hm, _ = _block_train(_mtp_kind(cfg),
                             _part(params, specs, "mtp_block"), h, cfg)
        hm = _norm(_part(params, specs, "mtp_norm"), hm, cfg)
        loss_mtp = _mtp_ce(head, cfg, hm, batch["labels"])
        metrics["mtp"] = loss_mtp
        loss = loss + 0.3 * loss_mtp
    if cfg.ot_loss_weight > 0:
        loss_ot = ot_prototype_loss(
            _part(params, specs, "ot"), h, eps=cfg.ot_eps,
            n_tokens=cfg.ot_tokens,
            n_iter=cfg.ot_iters, policy=policy)
        metrics["ot"] = loss_ot
        loss = loss + cfg.ot_loss_weight * loss_ot
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: caches / prefill / decode
# ---------------------------------------------------------------------------


def _stacked(cache, count: int):
    return type(cache)(*(t.expand((count,) + t.shape).contiguous()
                         for t in cache))


def _as_stack(cache):
    """An unstacked cache (a shared block's) as a stack of one: views, so
    the group writes below write it."""
    return type(cache)(*(t[None] for t in cache))


def init_caches(cfg: ArchConfig, batch: int, s_max: int, *,
                device=None) -> List[Cache]:
    """One cache a layer group, in the compute dtype, stacked on a leading
    axis of the group's layers: GQA k and v of (L, B, S_cache, KH, D),
    ``S_cache`` the window where there is one; MLA latents (L, B, S,
    kv_lora) and rope keys (L, B, S, qk_rope); Mamba2 conv histories (L,
    B, K - 1, conv_dim) and states (L, B, H, P, N); ``length`` (L,) int64.
    A ``shared_attn`` use has its own GQA cache, unstacked (B, S_cache,
    KH, D) with a 0-d ``length``, as in the reference."""
    check_ported(cfg)
    dev = init_device(device)
    win = effective_window(cfg, s_max)
    caches = []
    for kind, count in group_plan(cfg.layer_plan()):
        if kind == "mamba":
            c = init_mamba2_cache(batch, cfg.d_model,
                                  conv_kernel=cfg.conv_kernel,
                                  dtype=cfg.cdtype, device=dev,
                                  **_ssm_kw(cfg))
        elif _is_mla(kind):
            c = init_mla_cache(batch, s_max, kv_lora=cfg.kv_lora,
                               qk_rope=cfg.qk_rope, dtype=cfg.cdtype,
                               device=dev)
        else:
            c = init_gqa_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                               window=win, dtype=cfg.cdtype, device=dev)
        caches.append(c if kind == "shared_attn" else _stacked(c, count))
    return caches


def cache_logical_axes(cfg: ArchConfig) -> List[Cache]:
    """The logical axes of every cache leaf, in :func:`init_caches`'
    structure (``"skip"`` for ``length``): GQA and MLA caches put the KV
    sequence on ``kvseq`` (the flash-decoding contract), Mamba2 states
    their heads on ``heads``."""
    specs: List[Cache] = []
    for kind, _ in group_plan(cfg.layer_plan()):
        lead = () if kind == "shared_attn" else (None,)
        if kind in ("attn", "attn_moe", "dec_attn", "shared_attn"):
            c = GQACache(k=lead + ("batch", "kvseq", None, None),
                         v=lead + ("batch", "kvseq", None, None),
                         length="skip")
        elif _is_mla(kind):
            c = MLACache(c_kv=lead + ("batch", "kvseq", None),
                         k_rope=lead + ("batch", "kvseq", None),
                         length="skip")
        elif kind == "mamba":
            c = Mamba2Cache(conv=lead + ("batch", None, None),
                            state=lead + ("batch", "heads", None, None),
                            length="skip")
        else:
            raise ValueError(kind)
        specs.append(c)
    return specs


def shard_caches(cfg: ArchConfig, caches: List[Cache],
                 ctx: Optional[MeshContext] = None) -> List[Cache]:
    """The decode contract's batch rows of this rank (the current context
    by default): every leaf on ``batch`` cut over the data axes where they
    divide it; the caches as they are without a context. The KV sequence
    and the heads stay whole on each ``"model"`` rank (their partition is
    ROADMAP.md §A item 8e)."""
    ctx = current_mesh_context() if ctx is None else ctx
    if ctx is None:
        return caches
    out = []
    for cache, logical in zip(caches, cache_logical_axes(cfg)):
        fields = []
        for leaf, lg in zip(cache, logical):
            if lg != "skip" and "batch" in lg:
                dim = lg.index("batch")
                dp = resolve_logical("batch", tuple(ctx.sizes))
                n = ctx.size(dp)
                if dp and leaf.shape[dim] % n == 0:
                    rows = leaf.shape[dim] // n
                    leaf = leaf.narrow(dim, ctx.coord(dp) * rows,
                                       rows).clone()
            fields.append(leaf)
        out.append(type(cache)(*fields))
    return out


def _expect(cache, kind: type) -> None:
    if not isinstance(cache, kind):
        raise TypeError(f"a {type(cache).__name__} given to the "
                        f"{kind.__name__} write")


def _write_slots(cache, new, slot: torch.Tensor) -> None:
    """The new tokens' entries of every layer of a group into its two
    sequence buffers, at ``slot`` of the sequence axis."""
    for buf, column in zip(cache[:2], zip(*new)):
        buf.index_copy_(2, slot, torch.stack(column)[:, :, None])


def _write_gqa(cache: GQACache, new, window: Optional[int]) -> None:
    """A window's rolling buffer, or the position clamped to the last
    slot."""
    _expect(cache, GQACache)
    s_cache, pos = cache.k.shape[2], cache.length[:1]
    _write_slots(cache, new, torch.remainder(pos, s_cache) if window
                 else torch.clamp(pos, max=s_cache - 1))


def _write_mla(cache: MLACache, new) -> None:
    """MLA caches keep every position: the position clamped to the last
    slot."""
    _expect(cache, MLACache)
    _write_slots(cache, new, torch.clamp(cache.length[:1],
                                         max=cache.c_kv.shape[2] - 1))


def _write_mamba(cache: Mamba2Cache, new) -> None:
    """Each layer's whole new conv history and state."""
    _expect(cache, Mamba2Cache)
    for layer, (conv, state) in enumerate(new):
        cache.conv[layer].copy_(conv)
        cache.state[layer].copy_(state)


def decode_step(params, cfg: ArchConfig, token_batch: Dict,
                caches: List[Cache], *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """One-token decode: ``token_batch`` holds ``tokens`` (B, 1) or
    ``embeds`` (B, 1, d), and for an ``encdec`` config ``enc_kv``, the
    cached encoder keys and values ``{"k", "v"}``, each (n_layers, B, T,
    H, D). Returns ``(logits (B, 1, V), caches)``.

    Each group's cache is written once a step, after its layers have read
    it, and IN PLACE (the JAX package donates its caches): the returned
    caches are the given ones. Each cache kind has its own write (a
    sequence slot of GQA and MLA caches, the whole state of a Mamba2
    cache). ``window`` must be ``effective_window(cfg, s_max)`` of the
    session (the rolling buffer of a sliding window); without one the
    write clamps to the last slot. A learned position is the first
    group's ``length``, read on the device and clamped to the table."""
    check_ported(cfg)
    if cfg.input_kind == "embeds":
        x = token_batch["embeds"].to(cfg.cdtype)
    else:
        x = params["embed"]["table"].to(cfg.cdtype)[token_batch["tokens"]]
    if cfg.pos == "learned":
        pos = torch.clamp(caches[0].length.reshape(-1)[:1], 0, POS_ROWS - 1)
        x = x + params["pos"].index_select(0, pos).to(cfg.cdtype)
    enc_kv = token_batch.get("enc_kv")
    for (kind, count), cache, stack in zip(group_plan(cfg.layer_plan()),
                                           caches, params["groups"]):
        if kind == "shared_attn":
            kind, layers = "attn", [params["shared_attn"]]
            cache = _as_stack(cache)
        else:
            layers = _unstack(stack, count)
        new = []
        for layer, p_l in enumerate(layers):
            x, new_l = _block_decode(kind, p_l, x, cache, layer, cfg, window,
                                     enc_kv)
            new.append(new_l)
        if kind == "mamba":
            _write_mamba(cache, new)
        elif _is_mla(kind):
            _write_mla(cache, new)
        else:
            _write_gqa(cache, new, window)
        cache.length.add_(1)
    h = _norm(params["final_norm"], x, cfg)
    return _logits(params, cfg, h), caches


def prefill(params, cfg: ArchConfig, batch: Dict,
            specs=None) -> torch.Tensor:
    """The serving prefill: the full forward, then the logits of the last
    position, (B, 1, V). On a sequence split over ``"model"`` the last
    position is the last rank's, and its logits come back to every rank.
    ``specs``: as :func:`forward`'s."""
    h, _ = forward(params, cfg, batch, specs)
    logits = _logits(_head(params, cfg, specs), cfg, h[:, -1:, :])
    tp = seq_axis()
    if tp is None:
        return logits
    return all_gather(logits, tp, dim=1)[:, -1:]

