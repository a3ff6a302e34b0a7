"""repro_torch's MoE family at the model level against the JAX package,
on the CPU: the deepseek-v2 / v3 tiny configs through ``train_loss``
(the cross-entropy, the MoE layers' aux loss, v3's multi-token-prediction
loss and the OT prototype loss) with every gradient, ``decode_step`` on
MLA caches and ``prefill``, and one ``make_train_step`` step.

Both sides start from the port's seeded parameters, carried into the
reference's pytree (its own ``init_params`` draws other numbers from the
same distributions and costs seconds of eager compiles), and the same
numpy tokens; the reference runs under ``jax.jit``. Configs are float32.
Tolerances: ``ce``, ``aux``, ``mtp`` and the loss 1e-5 relative, ``ot``
1e-4 (both packages store the OT factors in bf16); logits and caches 1e-5
of max |value|; gradients 1e-4 (model leaves) and 1e-3 (``ot`` leaves) of
each leaf's max |grad|; after one step the parameters 1e-5 and the
moments 1e-4 of each leaf's max |value|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_update, init_adamw, \
    linear_warmup_cosine
from repro_torch.tree import named_leaves, tree_leaves, tree_map, \
    tree_unflatten

MOE = ["deepseek-v2-236b", "deepseek-v3-671b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
HIDDEN_TOL = 1e-5        # of max |value|
LOSS_RTOL = 1e-5         # ce, aux, mtp, the loss
OT_RTOL = 1e-4
GRAD_TOL = 1e-4          # of each model leaf's max |grad|
OT_GRAD_TOL = 1e-3       # of each ot leaf's max |grad|


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX tiny config, port tiny config, JAX params, port params, the
    reference's jitted ``value_and_grad`` of ``train_loss``): the port's
    seeded float32 draw, its leaves as the reference's arrays."""
    jc = j_get_config(arch).tiny(**F32)
    tc = get_config(arch).tiny(**F32)
    tp = TM.init_params(tc, seed=0, device="cpu")
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, jc, b), has_aux=True))
    return jc, tc, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp, grad


def _leaves_agree(got, want, tol_of):
    """Each leaf of ``got`` (port) within ``tol_of(name)`` of its max
    |value| in ``want`` (the reference's tree, numpy leaves)."""
    want = dict(named_leaves(want))
    names = [n for n, _ in named_leaves(got)]
    assert set(names) == set(want)
    for name, leaf in named_leaves(got):
        assert _rel_to_max(_np(leaf), want[name]) <= tol_of(name), name


def _grad_tol(name):
    return OT_GRAD_TOL if name.startswith("ot/") else GRAD_TOL


def _tokens(cfg, B=2, S=24, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return ({"tokens": jnp.asarray(tok[:, :-1], jnp.int32),
             "labels": jnp.asarray(tok[:, 1:], jnp.int32)},
            {"tokens": torch.tensor(tok[:, :-1]),
             "labels": torch.tensor(tok[:, 1:])})


def _port_grads(tp, fn):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    out, aux = fn(tree_unflatten(tp, leaves))
    return out, {k: v.detach() for k, v in aux.items()}, \
        torch.autograd.grad(out, leaves)


def test_train_loss_and_gradients_match_reference():
    """v3-tiny (v2-tiny is the same model without the MTP block): ``ce``,
    ``aux`` and ``mtp`` 1e-5 relative, ``ot`` 1e-4, every leaf's gradient
    within its bar; the router's gradient is not zero."""
    jc, tc, jp, tp, grad = _pair("deepseek-v3-671b")
    jb, tb = _tokens(jc)
    (_, mj), gj = grad(jp, jb)
    _, mt, gt = _port_grads(tp, lambda p: TM.train_loss(p, tc, tb))
    assert set(mt) == set(mj) == {"ce", "aux", "mtp", "ot", "loss"}
    for k in mt:
        rel = OT_RTOL if k == "ot" else LOSS_RTOL
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=rel), k
    _leaves_agree(tree_unflatten(tp, list(gt)),
                  jax.tree.map(np.asarray, gj), _grad_tol)
    names = [n for n, _ in named_leaves(tp)]
    router = gt[names.index("groups/1/moe/router")]
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_decode_and_prefill_match_reference(arch):
    """Six decode steps from ``init_caches`` (MLA caches written in place),
    each step's logits 1e-5 of max |logit| against the reference's
    ``decode_step``, the caches after them, and ``prefill`` of the six
    tokens against the reference's."""
    jc, tc, jp, tp, _ = _pair(arch)
    B, T, s_max = 2, 6, 8
    tok = np.random.default_rng(5).integers(0, jc.vocab, (B, T))
    jcache = JM.init_caches(jc, B, s_max)
    tcache = TM.init_caches(tc, B, s_max, device="cpu")
    assert all(isinstance(c, TA.MLACache) for c in tcache)
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c))
    with torch.no_grad():
        for i in range(T):
            lj, jcache = jstep(jp, {"tokens": jnp.asarray(tok[:, i:i + 1],
                                                          jnp.int32)},
                               jcache)
            lt, tcache = TM.decode_step(
                tp, tc, {"tokens": torch.tensor(tok[:, i:i + 1])}, tcache)
            assert lt.shape == (B, 1, tc.padded_vocab)
            assert _rel_to_max(_np(lt), lj) <= HIDDEN_TOL, i
        for got, want in zip([t for c in tcache for t in c],
                             jax.tree.leaves(jcache)):
            assert _rel_to_max(_np(got), want) <= HIDDEN_TOL
        assert int(tcache[1].length[0]) == T
        pj = jax.jit(lambda p, b: JM.prefill(p, jc, b))(
            jp, {"tokens": jnp.asarray(tok, jnp.int32)})
        pt = TM.prefill(tp, tc, {"tokens": torch.tensor(tok)})
    assert _rel_to_max(_np(pt), pj) <= HIDDEN_TOL


def test_one_train_step_matches_reference():
    """One ``make_train_step`` step of v3-tiny over a batch of 4 x 24 in
    two micro-batches (the router solving on each) against the reference's
    gradients of the two halves (its ``train_loss``, the same jitted
    function as above) accumulated and averaged, then the port's AdamW
    (held to the reference's in ``tests/test_torch_lm_train.py``) at eps
    1 and lr 1, where the first update is close to linear in the clipped
    gradient: the metrics at their bars, the moments (the clipped
    gradients) at the gradients' bars and the parameters within 1e-5 of
    each leaf's max |value|. ``zero3`` is off so that the moments stay
    float32; the config's own zero3 step takes four micro-batches and bf16
    moments, as the reference's does."""
    jc, tc, jp, tp, grad = _pair("deepseek-v3-671b")
    cfg = dataclasses.replace(tc, zero3=False)
    jb, tb = _tokens(jc, B=4, seed=2)
    halves = [grad(jp, {k: v[i:i + 2] for k, v in jb.items()})
              for i in (0, 2)]
    mj = {k: np.mean([float(m[k]) for (_, m), _ in halves])
          for k in halves[0][0][1]}
    gj = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) * 0.5,
                      halves[0][1], halves[1][1])
    opt = AdamWConfig(lr=1.0, eps=1.0)
    tstep, _ = make_train_step(cfg, None, ShapeSpec("t", 24, 4, "train"),
                               opt=opt, total_steps=50, micro_batches=2)
    assert tstep.micro_batches == 2
    p_np = tree_map(lambda t: t.numpy().copy(), tp)
    tnew, tstate, tm = tstep(tp, init_adamw(tp, opt), tb)
    for k in ("ce", "aux", "mtp", "loss"):
        assert float(tm[k]) == pytest.approx(mj[k], rel=LOSS_RTOL), k
    assert float(tm["ot"]) == pytest.approx(mj["ot"], rel=OT_RTOL)
    gj = dict(named_leaves(gj))
    gj = tree_unflatten(tp, [torch.tensor(gj[n]) for n, _ in
                             named_leaves(tp)])
    want_p, want_s, _ = adamw_update(
        tp, gj, init_adamw(tp, opt), opt,
        lr_schedule=linear_warmup_cosine(opt.lr, 6, 50))
    _leaves_agree(tstate.m, tree_map(lambda t: t.numpy(), want_s.m),
                  _grad_tol)
    _leaves_agree(tnew, tree_map(lambda t: t.numpy(), want_p),
                  lambda _: 1e-5)
    # the inputs are left as they were: a step is functional
    _leaves_agree(tp, p_np, lambda _: 0.0)
    zero3, _ = make_train_step(tc, None, ShapeSpec("t", 24, 4, "train"))
    assert zero3.micro_batches == 4
    assert zero3.opt.moment_dtype == "bfloat16"
