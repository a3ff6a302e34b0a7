"""repro_torch's MoE building blocks against the JAX package, on the
CPU: the Sinkhorn router (with NaN and tied plans), the router's two
kinds, the dense MoE layer and its gradients, multi-head latent attention
(train, step, decode), the deepseek-v2 / v3 parameter trees, their decode
caches, and the expert-parallel path on a one-rank mesh.
``tests/test_torch_moe_lm.py`` holds the two configs' losses, decode and
train step.

Inputs come from seeds (a layer's parameters from the port's seeded
``init_*``, carried into the reference leaf by leaf; the reference's
functions run under ``jax.jit``). Tolerances: the router's dispatch equal, combine
weights within 1e-6, the balance loss 1e-6 relative; the MoE layer's
output within 1e-5 of its max |value| (the port folds the combine weights
into the activations before the down projection, the reference contracts
the three operands in another order), its aux 1e-5 relative and its
gradients 1e-4 of each leaf's max |grad|; MLA 1e-5 of max |value|, and
decode against the port's own training forward at the reference's bars
(rtol 3e-3, atol 3e-4).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import ShapeSpec as JShape
from repro.core.objective import ExecutionPolicy as JPolicy
from repro.core.routing import sinkhorn_route as j_route
from repro.launch import specs as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core import ExecutionPolicy, balanced_plan, \
    sinkhorn_route, stable_top_k
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.tree import named_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))

MOE = ["deepseek-v2-236b", "deepseek-v3-671b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
COMBINE_TOL = 1e-6
BALANCE_RTOL = 1e-6
HIDDEN_TOL = 1e-5        # of max |value|
AUX_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |grad|


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _skewed_logits(T=256, E=8):
    """The reference's balance test: N(0, 1) logits plus a skew of 3 and 1
    on the first two experts."""
    skew = np.array([3.0, 1.0] + [0.0] * (E - 2), np.float32)
    rng = np.random.default_rng(11)
    return (rng.standard_normal((T, E)) + skew).astype(np.float32)


ROUTE_CASES = {
    # name: (logits, top_k, eps, n_iter)
    "normal": (np.random.default_rng(0).standard_normal((64, 8)), 2, 0.05,
               8),
    "wide": (0.5 * np.random.default_rng(1).standard_normal((256, 16)), 4,
             0.05, 8),
    "skewed": (_skewed_logits(), 2, 0.3, 50),
}
POLICY_ITERS = 8     # the skewed case's 50 under a policy that checks once


@pytest.mark.parametrize("case,precision", [
    ("normal", "highest"), ("normal", "bf16"), ("wide", "highest"),
    ("wide", "bf16"), ("skewed", None), ("skewed", "highest"),
    ("skewed", "bf16")])
def test_sinkhorn_route_matches_reference(case, precision):
    """Dispatch equal, combine and balance loss within their bars, with the
    f32 and bf16 policies (one check a solve, the kernel stored in bf16
    under ``bf16``), and the reference's skewed-logit balance test as it
    runs it (no policy: a check every iteration, 50 iterations)."""
    logits, k, eps, n_iter = ROUTE_CASES[case]
    logits = np.asarray(logits, np.float32)
    if precision is not None:
        n_iter = min(n_iter, POLICY_ITERS)
    jpol = None if precision is None else JPolicy(precision=precision)
    tpol = None if precision is None else ExecutionPolicy(
        precision=precision)
    jr = jax.jit(lambda lg: j_route(lg, top_k=k, eps=eps, n_iter=n_iter,
                                    policy=jpol))(jnp.asarray(logits))
    tr = sinkhorn_route(torch.tensor(logits), top_k=k, eps=eps,
                        n_iter=n_iter, policy=tpol)
    np.testing.assert_array_equal(tr.dispatch.numpy(),
                                  np.asarray(jr.dispatch))
    assert np.abs(tr.combine.numpy() - np.asarray(jr.combine)).max() <= \
        COMBINE_TOL
    assert float(tr.balance_loss) == pytest.approx(float(jr.balance_loss),
                                                   rel=BALANCE_RTOL)
    assert torch.all(tr.dispatch.sum(-1) == k)
    if case == "skewed":
        # the router balances the load better than softmax top-k does
        _, idx = stable_top_k(torch.softmax(torch.tensor(logits), -1), k)
        soft = torch.zeros_like(tr.dispatch).scatter_(1, idx, 1.0)

        def imbalance(d):
            load = d.mean(0)
            return float(load.max() / load.mean())

        assert imbalance(tr.dispatch) < imbalance(soft)


def test_non_finite_and_tied_rows_pick_the_references_experts():
    """``stable_top_k`` against ``jax.lax.top_k`` on an all-NaN row, a row
    with some NaN, tied rows and -inf; and a router whose plan underflows
    (logits of std 40 at eps 0.05, so C / eps reaches thousands and u, v
    and the plan are NaN): the same experts as the reference."""
    rows = np.array([
        [np.nan] * 8,
        [1.0, np.nan, 3.0, np.nan, 2.0, 2.0, 0.0, -1.0],
        [2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 0.0, 0.0],
        [0.0] * 8,
        [-np.inf, 1.0, -np.inf, 1.0, 0.5, np.nan, -np.inf, 0.5],
    ], np.float32)
    for k in (1, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = stable_top_k(torch.tensor(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    logits = (40.0 * np.random.default_rng(4).standard_normal((32, 8))
              ).astype(np.float32)
    res, plan = balanced_plan(torch.tensor(logits), eps=0.05, n_iter=8)
    assert not torch.isfinite(plan).all()
    jr = jax.jit(lambda lg: j_route(
        lg, top_k=2, policy=JPolicy(precision="bf16")))(jnp.asarray(logits))
    tr = sinkhorn_route(torch.tensor(logits), top_k=2,
                        policy=ExecutionPolicy(precision="bf16"))
    np.testing.assert_array_equal(tr.dispatch.numpy(),
                                  np.asarray(jr.dispatch))
    assert np.abs(tr.combine.numpy() - np.asarray(jr.combine)).max() <= \
        COMBINE_TOL


def _moe_pair(T=48, d=16, f=32, E=8, seed=0):
    """The reference's and the port's MoE parameters (the port's seeded
    draw in both) and a numpy input (T, d)."""
    tp = TMoE.init_moe(torch.Generator().manual_seed(seed), d, f, E,
                       device="cpu")
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = (0.5 * np.random.default_rng(seed).standard_normal((T, d))
         ).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("router", ["softmax", "sinkhorn"])
def test_router_probs_match_reference(router):
    jp, tp, x = _moe_pair()
    cj, aj = jax.jit(lambda p, xx: JMoE.router_probs(
        p, xx, top_k=2, router=router))(jp, jnp.asarray(x))
    ct, at = TMoE.router_probs(tp, torch.tensor(x), top_k=2, router=router)
    np.testing.assert_array_equal(ct.numpy() > 0, np.asarray(cj) > 0)
    assert np.abs(ct.numpy() - np.asarray(cj)).max() <= COMBINE_TOL
    assert float(at) == pytest.approx(float(aj), rel=BALANCE_RTOL)
    assert ct.dtype == torch.float32


@pytest.mark.parametrize("router", ["softmax", "sinkhorn"])
def test_moe_dense_and_gradients_match_reference(router):
    """The layer's output and aux, and the gradients of sum(out^2) + 0.01
    aux in x and every leaf (the router's through the straight-through
    combine weights) against ``jax.grad``."""
    jp, tp, x = _moe_pair()

    def j_loss(p, xx):
        out, aux = JMoE.moe_dense(p, xx, top_k=2, router=router)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (oj, aj)), (gpj, gxj) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    ot, at = TMoE.moe_dense(leaves, xt, top_k=2, router=router)
    grads = torch.autograd.grad(torch.sum(ot ** 2) + 0.01 * at,
                                [xt] + list(leaves.values()))
    assert _rel_to_max(_np(ot), oj) <= HIDDEN_TOL
    assert float(at) == pytest.approx(float(aj), rel=AUX_RTOL)
    assert _rel_to_max(_np(grads[0]), gxj) <= GRAD_TOL
    for k, g in zip(leaves, grads[1:]):
        assert _rel_to_max(_np(g), gpj[k]) <= GRAD_TOL, k
    assert float(grads[1 + list(leaves).index("router")].abs().max()) > 0


def test_mla_train_step_and_decode_match_reference():
    """MLA at the reference's test widths (d 64, 4 heads, kv_lora 32, q_lora
    48, nope 16, rope 8, v_head 16), B 2 x S 10: training (KV chunks of 3)
    against ``mla_train``; the read-only step and the self-writing decode
    token by token against the reference's, the decode's cache equal; and
    both against the port's training forward at the reference's bars."""
    kw = dict(n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)
    B, S, d = 2, 10, 64
    pt = TA.init_mla(torch.Generator().manual_seed(6), d, 4, kv_lora=32,
                     q_lora=48, qk_nope=16, qk_rope=8, v_head=16,
                     device="cpu")
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pt)
    x = (0.5 * np.random.default_rng(6).standard_normal((B, S, d))
         ).astype(np.float32)
    fj = jax.jit(lambda p, xx: JA.mla_train(p, xx, kv_chunk=3, **kw))(
        pj, jnp.asarray(x))
    j_step = jax.jit(lambda p, xx, c, r, n: JA.mla_attend_step(
        p, xx, c, r, n, **kw))
    j_decode = jax.jit(lambda p, xx, c: JA.mla_decode(p, xx, c, **kw))
    with torch.no_grad():
        ft = TA.mla_train(pt, torch.tensor(x), kv_chunk=3, **kw)
    assert _rel_to_max(_np(ft), fj) <= HIDDEN_TOL
    cj = JA.init_mla_cache(B, S, kv_lora=32, qk_rope=8)
    ct = TA.init_mla_cache(B, S, kv_lora=32, qk_rope=8)
    c_ro, r_ro = torch.zeros(B, S, 32), torch.zeros(B, S, 8)
    steps, decodes = [], []
    with torch.no_grad():
        for t in range(S):
            xt = x[:, t:t + 1]
            sj, cnj, rnj = j_step(pj, jnp.asarray(xt), cj.c_kv, cj.k_rope,
                                  cj.length)
            st, cnt, rnt = TA.mla_attend_step(
                pt, torch.tensor(xt), c_ro, r_ro, torch.tensor(t), **kw)
            assert _rel_to_max(_np(st), sj) <= HIDDEN_TOL
            assert _rel_to_max(_np(cnt), cnj) <= HIDDEN_TOL
            c_ro[:, t], r_ro[:, t] = cnt, rnt
            oj, cj = j_decode(pj, jnp.asarray(xt), cj)
            ot, ct = TA.mla_decode(pt, torch.tensor(xt), ct, **kw)
            assert _rel_to_max(_np(ot), oj) <= HIDDEN_TOL
            steps.append(st)
            decodes.append(ot)
    assert int(ct.length) == int(cj.length) == S
    assert _rel_to_max(_np(ct.c_kv), cj.c_kv) <= HIDDEN_TOL
    assert _rel_to_max(_np(ct.k_rope), cj.k_rope) <= HIDDEN_TOL
    for outs in (steps, decodes):
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ft.numpy(),
                                   rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("arch", MOE)
def test_params_convert_leaf_for_leaf(arch):
    """The tiny config in its own dtypes (bf16 parameters): the port's
    ``meta`` tree has the reference's names, shapes and dtypes
    (``jax.eval_shape``), the router float32 and the expert stacks (L, E,
    d, f) / (L, E, f, d) in bf16, the MTP block where the config has one;
    ``convert.lm_params`` carries a numpy tree of those names into them
    leaf for leaf; and the full-size count and shapes match."""
    jc, tc = j_get_config(arch).tiny(), get_config(arch).tiny()
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jc),
                            jax.random.PRNGKey(0))
    meta = dict(named_leaves(TM.init_params(tc, device="meta")))
    want = dict(named_leaves(shapes))
    assert set(meta) == set(want)
    for name, s in want.items():
        assert tuple(meta[name].shape) == tuple(s.shape), name
        assert str(meta[name].dtype).split(".")[1] == str(s.dtype), name
    assert ("mtp_block/attn/wq_down/w" in meta) == tc.mtp
    L, E, d, f = 1, tc.n_experts, tc.d_model, tc.moe_d_ff
    moe = "groups/1/moe/"
    assert meta[moe + "router"].dtype == torch.float32
    assert meta[moe + "router"].shape == (L, d, E)
    for k, shape in (("up", (L, E, d, f)), ("gate", (L, E, d, f)),
                     ("down", (L, E, f, d))):
        assert meta[moe + k].dtype == torch.bfloat16, k
        assert meta[moe + k].shape == shape, k
    rng = np.random.default_rng(8)
    p_np = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tp = dict(named_leaves(convert.lm_params(p_np, tc, device="cpu")))
    for name, arr in named_leaves(p_np):
        assert tp[name].dtype == meta[name].dtype, name
        assert torch.equal(tp[name], torch.tensor(arr).to(tp[name].dtype)), \
            name
    jfull, tfull = j_get_config(arch), get_config(arch)
    full = jax.eval_shape(lambda k: JM.init_params(k, jfull),
                          jax.random.PRNGKey(0))
    tmeta = TM.init_params(tfull, device="meta")
    assert {n: tuple(t.shape) for n, t in named_leaves(tmeta)} == \
        {n: tuple(s.shape) for n, s in named_leaves(full)}
    assert TM.param_count(tmeta) == sum(x.size for x in
                                        jax.tree.leaves(full))


@pytest.mark.parametrize("arch", MOE)
def test_cache_specs_match_reference(arch):
    """The decode caches on ``meta``: the reference's shapes, leaf for
    leaf, in the compute dtype (lengths int64, the port's index type), at
    the tiny and the full config; and the serve step's specs."""
    for jc, tc in ((j_get_config(arch).tiny(), get_config(arch).tiny()),
                   (j_get_config(arch), get_config(arch))):
        js = JS.cache_specs(jc, JShape("d", 128, 2, "decode"))
        ts = TS.cache_specs(tc, ShapeSpec("d", 128, 2, "decode"))
        got = [t for c in ts for t in c]
        want = jax.tree.leaves(js)
        assert [tuple(t.shape) for t in got] == [tuple(s.shape)
                                                for s in want]
        assert all(t.is_meta for t in got)
        for c in ts:
            assert c.c_kv.dtype == c.k_rope.dtype == tc.cdtype
            assert c.length.dtype == torch.int64
    _, (_, in_specs, caches) = make_serve_step(
        get_config(arch).tiny(), None, ShapeSpec("d", 16, 2, "decode"))
    assert in_specs["tokens"].shape == (2, 1)
    assert [tuple(c.c_kv.shape) for c in caches] == [(1, 2, 16, 32)] * 2


def test_moe_on_a_mesh_of_more_than_one_rank_raises(tmp_path, monkeypatch):
    """The MoE on a mesh runs the expert-parallel path it once refused
    (its worlds of 2 and 4 ranks are held against the reference in
    ``tests/test_torch_multicard.py``): in a gloo world of this process
    alone, ``make_train_step`` takes a 1 x 1 mesh, and ``train_loss``
    under its mesh context sends every MoE layer through
    ``moe_ep_local``; at a capacity no assignment overflows, its loss
    equals the dense experts' (no context)."""
    import torch_sharded_worker as W
    from repro_torch.distributed import MeshContext, use_mesh_context
    from repro_torch.launch.mesh import make_local_mesh

    cfg = dataclasses.replace(get_config("deepseek-v3-671b").tiny(**F32),
                              capacity_factor=8.0)
    params = TM.init_params(cfg, device="cpu")
    tok = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (1, 9)))
    tb = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    dense, _ = TM.train_loss(params, cfg, tb)
    calls = []
    real = TM.moe_ep_local
    monkeypatch.setattr(TM, "moe_ep_local",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with W.world_of_one(tmp_path / "init"):
        mesh = make_local_mesh(1, 1, device="cpu")
        make_train_step(cfg, mesh, ShapeSpec("t", 16, 4, "train"))
        with use_mesh_context(MeshContext(mesh)):
            ep, metrics = TM.train_loss(params, cfg, tb)
    n_moe = sum(1 for k in cfg.layer_plan() if k.endswith("_moe"))
    assert len(calls) == n_moe > 0
    assert float(ep) == pytest.approx(float(dense), rel=1e-5)