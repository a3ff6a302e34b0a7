"""repro_torch's LM models (dense and vlm families) against the JAX package,
on the CPU.

The JAX side builds its parameters with ``init_params``; the port takes
the same arrays through ``convert.lm_params``, and the same numpy inputs
go through both (the JAX functions under ``jax.jit``). Configs are the
``tiny`` ones (2 layers, d_model 128) in float32, the dtype both drivers
train in. Tolerances: hidden states and logits within 1e-5 of their max
|value|; ``ce`` 1e-5 relative; ``ot`` 1e-4 relative (both packages store
the OT factors in bf16); gradients 1e-4 of each leaf's max |grad| for
model leaves and 1e-3 for the ``ot`` leaves; the subsample indices equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import all_cells as j_all_cells
from repro.configs.shapes import cell_applicable as j_cell_applicable
from repro.core.objective import ExecutionPolicy as JPolicy
from repro.models import model as JM
from repro.models import attention as JA
from repro.models.ot_loss import init_ot_loss as j_init_ot_loss
from repro.models.ot_loss import ot_prototype_loss as j_ot_loss
from repro.models.ot_loss import subsample_tokens as j_subsample
from repro_torch import convert
from repro_torch.configs import SHAPES, all_cells, cell_applicable, \
    get_config, list_archs
from repro_torch.core.objective import ExecutionPolicy
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import trunc_normal
from repro_torch.models.ot_loss import ot_prototype_loss, subsample_indices, \
    subsample_tokens
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

DENSE = ["smollm-135m", "qwen2-1.5b", "h2o-danube-3-4b", "deepseek-7b",
         "internvl2-26b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
HIDDEN_TOL = 1e-5        # of max |value|
CE_RTOL = 1e-5
OT_RTOL = 1e-4
GRAD_TOL = 1e-4          # of each model leaf's max |grad|
OT_GRAD_TOL = 1e-3       # of each ot leaf's max |grad|


def _pair(arch, **over):
    """(JAX tiny config, port tiny config, JAX params, port params)."""
    jc = j_get_config(arch).tiny(**F32, **over)
    tc = get_config(arch).tiny(**F32, **over)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1))
    labels = tok[:, 1:]
    if cfg.input_kind == "embeds":
        emb = (0.02 * rng.standard_normal((B, S, cfg.d_model))
               ).astype(np.float32)
        return ({"embeds": jnp.asarray(emb),
                 "labels": jnp.asarray(labels, jnp.int32)},
                {"embeds": torch.tensor(emb), "labels": torch.tensor(labels)})
    return ({"tokens": jnp.asarray(tok[:, :-1], jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.tensor(tok[:, :-1]),
             "labels": torch.tensor(labels)})


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _grads_agree(jgrads, tparams, tgrads):
    """Each leaf's gradient within its bar of the leaf's max |grad|."""
    want = dict(named_leaves(jax.tree.map(np.asarray, jgrads)))
    names = [n for n, _ in named_leaves(tparams)]
    assert set(names) == set(want)
    for name, g in zip(names, tgrads):
        tol = OT_GRAD_TOL if name.startswith("ot/") else GRAD_TOL
        assert _rel_to_max(g.detach().numpy(), want[name]) <= tol, name


def _port_grads(tp, fn):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    tp = tree_unflatten(tp, leaves)
    out, aux = fn(tp)
    return out, {k: v.detach() for k, v in aux.items()}, \
        torch.autograd.grad(out, leaves)


def test_configs_are_the_references():
    """All ten records field for field (full and tiny), the four shapes and
    their applicability."""
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        c, j = get_config(arch), j_get_config(arch)
        assert dataclasses.asdict(c) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(c.tiny()) == dataclasses.asdict(j.tiny())
        assert c.layer_plan() == j.layer_plan()
        assert c.padded_vocab == j.padded_vocab
        assert TM.group_plan(c.layer_plan()) == JM.group_plan(j.layer_plan())
        for s in SHAPES:
            assert cell_applicable(c, SHAPES[s])[0] == \
                j_cell_applicable(j, J_SHAPES[s])[0]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert all_cells() == j_all_cells()
    assert get_config("smollm-135m").dtype == torch.float32
    assert get_config("qwen2-1.5b").cdtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    """Hidden states after the final norm, 1e-5 of max |value|: GQA,
    QKV bias and rope 1e6 (qwen2), a window shorter than the sequence
    (h2o-danube, window 8 over 24), MHA (deepseek-7b) and embeddings in
    (internvl2)."""
    over = {"window": 8} if arch.startswith("h2o") else {}
    jc, tc, jp, tp = _pair(arch, **over)
    jb, tb = _batch(jc)
    hj, _ = jax.jit(lambda p, b: JM.forward(p, jc, b))(jp, jb)
    with torch.no_grad():
        ht, aux = TM.forward(tp, tc, tb)
    assert float(aux) == 0.0
    assert _rel_to_max(ht.numpy(), hj) <= HIDDEN_TOL


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-7b",
                                  "internvl2-26b"])
def test_train_loss_and_gradients_match_reference(arch):
    """``ce`` 1e-5 and ``ot`` 1e-4 relative, the loss 1e-5, every leaf's
    gradient within its bar: tied embeddings (smollm), an untied head
    (deepseek-7b), embeddings in (internvl2)."""
    jc, tc, jp, tp = _pair(arch)
    jb, tb = _batch(jc)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, jc, b), has_aux=True))(jp, jb)
    lt, mt, gt = _port_grads(tp, lambda p: TM.train_loss(p, tc, tb))
    assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), rel=CE_RTOL)
    assert float(mt["ot"]) == pytest.approx(float(mj["ot"]), rel=OT_RTOL)
    assert float(lt) == pytest.approx(float(lj), rel=CE_RTOL)
    _grads_agree(gj, tp, gt)


def test_chunked_cross_entropy_matches_reference():
    """A padded vocab of 32768 takes the chunked cross-entropy (16 vocab
    chunks, each recomputed in the backward); with tied embeddings the
    table's gradient comes from the gather and the head together."""
    jc, tc, jp, tp = _pair("smollm-135m", vocab=32768, ot_loss_weight=0.0)
    assert tc.padded_vocab >= 32768
    jb, tb = _batch(jc, B=2, S=8)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, jc, b), has_aux=True))(jp, jb)
    lt, mt, gt = _port_grads(tp, lambda p: TM.train_loss(p, tc, tb))
    assert "ot" not in mt
    assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), rel=CE_RTOL)
    _grads_agree(gj, tp, gt)
    # the same loss as the unchunked cross-entropy
    with torch.no_grad():
        h, _ = TM.forward(tp, tc, tb)
        full = TM._xent(TM._logits(tp, tc, h), tb["labels"])
    assert float(full) == pytest.approx(float(mt["ce"]), rel=CE_RTOL)


@pytest.mark.parametrize("n_tokens", [40, 64])
def test_ot_prototype_loss_matches_reference(n_tokens):
    """Alone, on hidden states of 2 x 24 = 48 tokens: a subsample of 40
    (evenly spaced, the same numpy indices) and all of them (64 >= 48);
    loss 1e-4 relative, gradients in the hidden states and the three OT
    leaves 1e-3 of their max |grad|."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 24, 32)).astype(np.float32)
    p_j = j_init_ot_loss(jax.random.PRNGKey(1), 32, ot_dim=8, n_protos=20,
                         n_features=16, eps=2.0)
    p_np = {k: np.asarray(v) for k, v in p_j.items()}
    idx = subsample_indices(2, 24, n_tokens)
    assert len(idx) == min(n_tokens, 48)
    np.testing.assert_array_equal(
        np.asarray(j_subsample(jnp.arange(48.0).reshape(2, 24, 1),
                               n_tokens))[:, 0], idx)
    np.testing.assert_array_equal(
        subsample_tokens(torch.arange(48.0).reshape(2, 24, 1),
                         n_tokens)[:, 0].numpy(), idx)

    def j_loss(p, hh):
        return j_ot_loss(p, hh, eps=2.0, n_tokens=n_tokens, n_iter=10,
                         policy=JPolicy.training())

    lj, (gpj, ghj) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        p_j, jnp.asarray(h))
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    ht = torch.tensor(h, requires_grad=True)
    lt = ot_prototype_loss(pt, ht, eps=2.0, n_tokens=n_tokens, n_iter=10,
                           policy=ExecutionPolicy.training(device="cpu"))
    grads = torch.autograd.grad(lt, [ht] + list(pt.values()))
    assert float(lt) == pytest.approx(float(lj), rel=OT_RTOL)
    assert _rel_to_max(grads[0].numpy(), ghj) <= OT_GRAD_TOL
    for (k, _), g in zip(pt.items(), grads[1:]):
        assert _rel_to_max(g.numpy(), gpj[k]) <= OT_GRAD_TOL, k


@pytest.mark.parametrize("arch,window", [("smollm-135m", None),
                                         ("h2o-danube-3-4b", 4)])
def test_decode_matches_reference(arch, window):
    """Six decode steps from ``init_caches``: each step's logits 1e-5 of
    max |logit| against the reference's ``decode_step``; with a window of
    4 over 6 tokens the rolling cache wraps. ``prefill`` of the 6-token
    prefix gives the last step's logits, and without a window the port's
    decode matches its own prefill at every prefix."""
    over = {"window": window} if window else {}
    jc, tc, jp, tp = _pair(arch, **over)
    B, T = 2, 6
    s_max = T if window is None else 16
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jc.vocab, (B, T))
    win_j = JM.effective_window(jc, s_max)
    win_t = TM.effective_window(tc, s_max)
    assert win_j == win_t == window
    jcache = JM.init_caches(jc, B, s_max)
    tcache = TM.init_caches(tc, B, s_max, device="cpu")
    if window:
        assert tcache[0].k.shape[2] == window < T
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c,
                                                   window=win_j))
    with torch.no_grad():
        for i in range(T):
            lj, jcache = jstep(jp, {"tokens": jnp.asarray(tok[:, i:i + 1],
                                                          jnp.int32)},
                               jcache)
            lt, tcache = TM.decode_step(tp, tc,
                                        {"tokens": torch.tensor(
                                            tok[:, i:i + 1])},
                                        tcache, window=win_t)
            assert lt.shape == (B, 1, tc.padded_vocab)
            assert _rel_to_max(lt.numpy(), lj) <= HIDDEN_TOL, i
            if window is None:
                pre = TM.prefill(tp, tc, {"tokens": torch.tensor(
                    tok[:, :i + 1])})
                assert _rel_to_max(pre.numpy(), lj) <= HIDDEN_TOL, i
        assert int(tcache[0].length[0]) == T
        pj = jax.jit(lambda p, b: JM.prefill(p, jc, b))(
            jp, {"tokens": jnp.asarray(tok, jnp.int32)})
        pt = TM.prefill(tp, tc, {"tokens": torch.tensor(tok)})
    assert _rel_to_max(pt.numpy(), pj) <= HIDDEN_TOL


def test_gqa_decode_matches_reference():
    """The one-layer decode that writes its own rolling cache (window 3
    over 5 tokens), against the reference's, and the cache it returns."""
    rng = np.random.default_rng(7)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, window=3)
    pj = JA.init_gqa(jax.random.PRNGKey(2), 16, 4, 2, 8)
    pt = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), pj)
    cj = JA.init_gqa_cache(2, 8, 2, 8, window=3)
    ct = TA.init_gqa_cache(2, 8, 2, 8, window=3)
    for _ in range(5):
        x = rng.standard_normal((2, 1, 16)).astype(np.float32)
        oj, cj = JA.gqa_decode(pj, jnp.asarray(x), cj, **kw)
        ot, ct = TA.gqa_decode(pt, torch.tensor(x), ct, **kw)
        assert _rel_to_max(ot.numpy(), oj) <= HIDDEN_TOL
    assert _rel_to_max(ct.k.numpy(), cj.k) <= HIDDEN_TOL
    assert int(ct.length) == int(cj.length) == 5


@pytest.mark.parametrize("arch", DENSE + ["whisper-base"])
def test_param_count_matches_reference_at_full_size(arch):
    """Full-size parameter counts, nothing allocated: ``jax.eval_shape``
    on the reference, ``meta`` tensors on the port; every leaf's shape."""
    jc, tc = j_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jc),
                            jax.random.PRNGKey(0))
    tp = TM.init_params(tc, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(tp))
    assert TM.param_count(tp) == sum(x.size for x in jax.tree.leaves(shapes))
    want = {n: tuple(s.shape) for n, s in named_leaves(shapes)}
    assert {n: tuple(t.shape) for n, t in named_leaves(tp)} == want
    if arch == "smollm-135m":
        assert TM.param_count(tp) == 134_536_512
    if arch == "whisper-base":
        assert TM.param_count(tp) == 130_863_104
        assert want["pos"] == (65536, 512)
        assert want["encoder/attn/wq/w"] == (6, 512, 512)
        assert want["groups/0/xattn/wk/w"] == (6, 512, 512)


def test_trunc_normal_is_std_times_a_normal_truncated_at_two():
    gen = torch.Generator().manual_seed(0)
    x = trunc_normal((200_000,), 0.02, generator=gen, device="cpu")
    assert float(x.abs().max()) <= 0.04
    # the variance of N(0, 1) truncated to [-2, 2] is 0.7737
    assert float(x.std()) == pytest.approx(0.02 * 0.7737 ** 0.5, rel=1e-2)
    assert trunc_normal((3, 4), generator=None, device="meta").is_meta


def test_execution_policy_from_config():
    """The run-wide policy from the config's ``ot_*`` fields, as the
    reference builds it, with the port's device field."""
    cfg = dataclasses.replace(get_config("smollm-135m"), ot_use_pallas=True,
                              ot_inner_steps=4, ot_check_every=8)
    pol = ExecutionPolicy.from_config(cfg, device="cpu")
    jpol = JPolicy.from_config(cfg)
    for f in ("precision", "use_pallas", "inner_steps", "check_every"):
        assert getattr(pol, f) == getattr(jpol, f), f
    assert pol.device == "cpu" and pol.mesh is None
    assert "device=cpu precision=bf16 pallas=on cadence=4/8" in \
        pol.describe()
    assert ExecutionPolicy.from_config(object()).precision == "bf16"
