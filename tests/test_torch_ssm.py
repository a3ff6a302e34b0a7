"""repro_torch's SSM and hybrid families against the JAX package, on the
CPU: the chunked SSD (``ssd_chunked``) at the reference's own (S, chunk)
cases with and without an initial state, one Mamba2 mixer in training and
decode, the mamba2 and zamba2 tiny configs through ``forward``,
``train_loss`` with every gradient (mamba2 once more at its config's
bf16 OT factors: the loss and the OT leaves) and ``decode_step`` (zamba2
with two uses of the shared block, and with a rolling window that
wraps), the
full-size parameter trees and the ``long_500k`` caches on ``meta``, one
AdamW step with a checkpoint of the hybrid's tree (whose shared-block
groups hold no leaves), the per-kind cache writes, and the SSD's context
parallel path on a one-rank mesh.

Inputs are made from seeds with numpy. A model's parameters are the
port's seeded draw laid out as the reference holds them (``None`` for a
hybrid's shared-block groups), handed to the reference as arrays and to
the port through ``convert.lm_params`` (the reference's own
``init_params`` draws other numbers from the same distributions and costs
seconds of eager compiles); the reference's model functions run under
``jax.jit``. Parameters and activations are float32. Tolerances: the SSD, the mixer, hidden
states, logits and caches within 1e-5 of max |value|; ``ce`` and the loss
1e-5 relative, ``ot`` 1e-4; gradients 1e-4 of each model leaf's max
|grad| and 1e-3 of each ``ot`` leaf's; a checkpoint restored bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import specs as JS
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.tree import named_leaves, tree_leaves, tree_map, \
    tree_unflatten

F32 = dict(param_dtype="float32", compute_dtype="float32")
HIDDEN_TOL = 1e-5        # of max |value|
LOSS_RTOL = 1e-5         # ce, the loss
OT_RTOL = 1e-4
GRAD_TOL = 1e-4          # of each model leaf's max |grad|
OT_GRAD_TOL = 1e-3       # of each ot leaf's max |grad|
TINY = {"mamba2-1.3b": {}, "zamba2-1.2b": {"n_layers": 7}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at the tiny
    widths the port is op-overhead bound, and torch's pool otherwise
    contends with XLA's on the same cores (25x slower steps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _reference_layout(tc, params):
    """The port's parameters as numpy arrays in the reference's layout:
    ``None`` where the port holds a shared-block group's empty dict."""
    tree = tree_map(lambda t: t.detach().numpy().copy(), params)
    plan = TM.group_plan(tc.layer_plan())
    tree["groups"] = [None if kind == "shared_attn" else g
                      for g, (kind, _) in zip(tree["groups"], plan)]
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch, **over):
    """(JAX tiny config, port tiny config, JAX params, port params): the
    port's seeded float32 draw in the reference's layout, to the reference
    as arrays and back to the port through ``convert.lm_params``."""
    over = dict(TINY[arch], **over)
    jc = j_get_config(arch).tiny(**F32, **over)
    tc = get_config(arch).tiny(**F32, **over)
    tree = _reference_layout(tc, TM.init_params(tc, seed=0, device="cpu"))
    jp = jax.tree.map(jnp.asarray, tree)
    return jc, tc, jp, convert.lm_params(tree, tc, device="cpu")


def _reference_grads(gj):
    """The reference's gradient tree by the port's leaf names (its
    ``None`` groups, leaves in ``torch.utils._pytree``, dropped)."""
    return dict(named_leaves(convert._port_layout(
        jax.tree.map(np.asarray, gj))))


def _tokens(cfg, B=2, S=24, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return ({"tokens": jnp.asarray(tok[:, :-1], jnp.int32),
             "labels": jnp.asarray(tok[:, 1:], jnp.int32)},
            {"tokens": torch.tensor(tok[:, :-1]),
             "labels": torch.tensor(tok[:, 1:])})


def _ssd_inputs(S, seed=0, B=2, H=3, P=4, N=5):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("S,chunk", [(16, 4), (17, 4), (32, 32), (30, 7)])
def test_ssd_chunked_matches_reference(S, chunk, init):
    """``y`` and the final state, 1e-5 of max |value|: one chunk, several,
    a padded tail (17 / 4 and 30 / 7), with and without a state carried
    in."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S)
    kw = dict(chunk=chunk)
    yj, hj = jax.jit(functools.partial(JSSM.ssd_chunked, **kw))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)),
        init_state=jnp.asarray(h0) if init else None)
    yt, ht = TSSM.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)),
                              init_state=torch.tensor(h0) if init else None,
                              **kw)
    assert yt.shape == (2, S, 3, 4) and ht.shape == (2, 3, 4, 5)
    assert _rel_to_max(yt.numpy(), yj) <= HIDDEN_TOL
    assert _rel_to_max(ht.numpy(), hj) <= HIDDEN_TOL


def test_mamba2_mixer_train_and_decode_match_reference():
    """One mixer (d 32, N 8, P 8, chunk 4) on 10 tokens: ``mamba2_train``
    against the reference's, then ten ``mamba2_decode`` steps, each
    output and the caches after them against the reference's, and the
    decode against the port's own training form at the reference's bars
    (rtol 3e-3, atol 3e-4)."""
    kw = dict(d_state=8, head_dim=8, expand=2)
    pt = TSSM.init_mamba2(torch.Generator().manual_seed(2), 32,
                          conv_kernel=4, device="cpu", **kw)
    pj = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), pt))
    rng = np.random.default_rng(4)
    x = (0.5 * rng.standard_normal((2, 10, 32))).astype(np.float32)
    yj = jax.jit(functools.partial(JSSM.mamba2_train, chunk=4, **kw))(
        pj, jnp.asarray(x))
    jstep = jax.jit(functools.partial(JSSM.mamba2_decode, **kw))
    with torch.no_grad():
        yt = TSSM.mamba2_train(pt, torch.tensor(x), chunk=4, **kw)
        assert _rel_to_max(yt.numpy(), yj) <= HIDDEN_TOL
        cj = JSSM.init_mamba2_cache(2, 32, conv_kernel=4, **kw)
        ct = TSSM.init_mamba2_cache(2, 32, conv_kernel=4, device="cpu", **kw)
        outs = []
        for t in range(10):
            oj, cj = jstep(pj, jnp.asarray(x[:, t:t + 1]), cj)
            ot, ct = TSSM.mamba2_decode(pt, torch.tensor(x[:, t:t + 1]), ct,
                                        **kw)
            assert _rel_to_max(ot.numpy(), oj) <= HIDDEN_TOL, t
            outs.append(ot)
    for got, want in zip(ct[:2], cj[:2]):
        assert _rel_to_max(got.numpy(), want) <= HIDDEN_TOL
    assert int(ct.length) == int(cj.length) == 10
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), yt.numpy(),
                               rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("arch,ot", [("mamba2-1.3b", 0.1),
                                     ("zamba2-1.2b", 0.0)])
def test_forward_loss_and_gradients_match_reference(arch, ot, monkeypatch):
    """Hidden states 1e-5 of max |value|; ``ce`` and the loss 1e-5, ``ot``
    1e-4 relative; every leaf's gradient within its bar: mamba2 (tied
    embeddings) and zamba2 at 7 layers, two uses of the shared block,
    whose gradient is the sum over both. mamba2 carries the OT loss,
    with its factors in float32 (``ot_precision="highest"``): with the
    config's bf16 factors a last-bit change of the hidden states can round
    a factor the other way, which moves mamba2-tiny's model gradients by
    up to 2.1e-4 of a leaf's max; in float32 they agree to 2.4e-5. zamba2
    runs without it (its compile doubles the reference's; the OT loss's
    own parity is ``tests/test_torch_lm.py``'s). The reference's hidden
    states are those its ``train_loss`` computes, read in the same trace
    (a second ``forward`` would add a third to the compile)."""
    jc, tc, jp, tp = _pair(arch, ot_precision="highest", ot_loss_weight=ot)
    jb, tb = _tokens(jc)
    j_forward, seen = JM.forward, {}

    def spy(*args, **kw):
        seen["h"], aux = j_forward(*args, **kw)
        return seen["h"], aux

    def j_loss(p, b):
        with monkeypatch.context() as m:
            m.setattr(JM, "forward", spy)
            loss, metrics = JM.train_loss(p, jc, b)
        return loss, (metrics, seen["h"])

    (lj, (mj, hj)), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, jb)
    with torch.no_grad():
        ht, aux = TM.forward(tp, tc, tb)
    assert float(aux) == 0.0
    assert _rel_to_max(ht.numpy(), hj) <= HIDDEN_TOL
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    lt, mt = TM.train_loss(tree_unflatten(tp, leaves), tc, tb)
    gt = torch.autograd.grad(lt, leaves)
    mt = {k: v.detach() for k, v in mt.items()}
    assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), rel=LOSS_RTOL)
    assert ("ot" in mt) == ("ot" in mj) == (ot > 0)
    if ot:
        assert float(mt["ot"]) == pytest.approx(float(mj["ot"]),
                                                rel=OT_RTOL)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=LOSS_RTOL)
    want = _reference_grads(gj)
    names = [n for n, _ in named_leaves(tp)]
    assert set(names) == set(want)
    for name, g in zip(names, gt):
        tol = OT_GRAD_TOL if name.startswith("ot/") else GRAD_TOL
        assert _rel_to_max(g.numpy(), want[name]) <= tol, name
    if arch.startswith("zamba2"):
        assert TM.group_plan(tc.layer_plan()).count(("shared_attn", 1)) == 2
        assert float(gt[names.index("shared_attn/attn/wq/w")].abs().max()) > 0


def test_bf16_factors_hold_the_loss_and_the_ot_gradients():
    """mamba2-tiny at its config's own OT precision (bf16 factors): ``ce``
    and the loss 1e-5, ``ot`` 1e-4 relative, and every ``ot`` leaf's
    gradient 1e-3 of its max. The model leaves are held at float32
    factors above and left out here: a last-bit difference of the hidden
    states can round a bf16 factor the other way, which moves them by up
    to 2.1e-4 of a leaf's max at this size."""
    jc, tc, jp, tp = _pair("mamba2-1.3b")
    assert tc.ot_precision == jc.ot_precision == "bf16"
    assert tc.ot_loss_weight > 0
    jb, tb = _tokens(jc)

    def j_loss(ot, p, b):
        return JM.train_loss(dict(p, ot=ot), jc, b)

    (lj, mj), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp["ot"], jp, jb)
    ot_leaves = [t.detach().requires_grad_(True)
                 for t in tree_leaves(tp["ot"])]
    lt, mt = TM.train_loss(dict(tp, ot=tree_unflatten(tp["ot"], ot_leaves)),
                           tc, tb)
    gt = torch.autograd.grad(lt, ot_leaves)
    mt = {k: v.detach() for k, v in mt.items()}
    assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), rel=LOSS_RTOL)
    assert float(mt["ot"]) == pytest.approx(float(mj["ot"]), rel=OT_RTOL)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=LOSS_RTOL)
    want = dict(named_leaves(jax.tree.map(np.asarray, gj)))
    names = [n for n, _ in named_leaves(tp["ot"])]
    assert names and set(names) == set(want)
    for name, g in zip(names, gt):
        assert _rel_to_max(g.numpy(), want[name]) <= OT_GRAD_TOL, name


@pytest.mark.parametrize("arch,over,s_max,T", [
    ("mamba2-1.3b", {}, 8, 8),
    ("zamba2-1.2b", {"long_context_window": 8}, 65537, 20)])
def test_decode_matches_reference(arch, over, s_max, T):
    """``T`` decode steps from ``init_caches``, each step's logits 1e-5 of
    max |logit| against the reference's ``decode_step``, then every cache
    leaf. zamba2 at s_max 65537 takes its long-context window of 8 slots,
    so the two shared-attention caches wrap over 20 tokens; the mamba
    states carry every token. mamba2's decode also equals its own
    ``prefill`` of the same tokens."""
    jc, tc, jp, tp = _pair(arch, **over)
    B = 2
    tok = np.random.default_rng(5).integers(0, jc.vocab, (B, T))
    win = TM.effective_window(tc, s_max)
    assert win == JM.effective_window(jc, s_max) == over.get(
        "long_context_window")
    jcache = JM.init_caches(jc, B, s_max)
    tcache = TM.init_caches(tc, B, s_max, device="cpu")
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c, window=win))
    with torch.no_grad():
        for i in range(T):
            lj, jcache = jstep(jp, {"tokens": jnp.asarray(tok[:, i:i + 1],
                                                          jnp.int32)},
                               jcache)
            lt, tcache = TM.decode_step(
                tp, tc, {"tokens": torch.tensor(tok[:, i:i + 1])}, tcache,
                window=win)
            assert lt.shape == (B, 1, tc.padded_vocab)
            assert _rel_to_max(_np(lt), lj) <= HIDDEN_TOL, i
        got, want = tree_leaves(tcache), jax.tree.leaves(jcache)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert _rel_to_max(_np(g), w) <= HIDDEN_TOL
        if win is None:
            pre = TM.prefill(tp, tc, {"tokens": torch.tensor(tok)})
            assert _rel_to_max(_np(pre), _np(lt)) <= HIDDEN_TOL
    kinds = [type(c) for c in tcache]
    assert TSSM.Mamba2Cache in kinds
    if arch.startswith("zamba2"):
        shared = [c for c, (k, _) in zip(tcache, TM.group_plan(
            tc.layer_plan())) if k == "shared_attn"]
        assert len(shared) == 2
        assert all(c.k.shape == (B, 8, tc.n_kv_heads, tc.head_dim)
                   and int(c.length) == T for c in shared)


@pytest.mark.parametrize("arch", list(TINY))
def test_param_tree_matches_reference_at_full_size(arch):
    """Full-size parameter counts and every leaf's name and shape, nothing
    allocated (``jax.eval_shape`` on the reference, ``meta`` tensors on
    the port); zamba2's shared block is held once, its groups none."""
    jc, tc = j_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jc),
                            jax.random.PRNGKey(0))
    tp = TM.init_params(tc, device="meta")
    assert all(t.is_meta for t in tree_leaves(tp))
    assert TM.param_count(tp) == sum(x.size for x in jax.tree.leaves(shapes))
    want = {n: tuple(s.shape)
            for n, s in named_leaves(convert._port_layout(shapes))}
    assert {n: tuple(t.shape) for n, t in named_leaves(tp)} == want
    if arch.startswith("mamba2"):
        assert TM.param_count(tp) == 1_344_097_280
        assert want["groups/0/mixer/in_proj/w"] == (48, 2048, 8512)
    else:
        assert TM.param_count(tp) == 1_016_999_936
        assert want["shared_attn/attn/wq/w"] == (2048, 2048)
        assert [g for g in tp["groups"] if not g] == [{}] * 6


def test_long_500k_cache_specs_match_reference():
    """``cache_specs`` of ``long_500k`` (S = 524288, batch 1) on ``meta``:
    every leaf's shape the reference's; zamba2's six shared-attention
    caches are 4096-slot rolling buffers, its 32 mamba states and
    mamba2's 48 O(1) in S."""
    shape = SHAPES["long_500k"]
    nbytes = {}
    for arch in TINY:
        jc, tc = j_get_config(arch), get_config(arch)
        js = JS.cache_specs(jc, J_SHAPES["long_500k"])
        ts = TS.cache_specs(tc, shape)
        got, want = tree_leaves(ts), jax.tree.leaves(js)
        assert [tuple(t.shape) for t in got] == [tuple(w.shape)
                                                 for w in want]
        assert all(t.is_meta for t in got)
        nbytes[arch] = sum(t.numel() * t.element_size() for t in got)
        plan = TM.group_plan(tc.layer_plan())
        gqa = [c for c, (k, _) in zip(ts, plan) if k == "shared_attn"]
        assert len(gqa) == (6 if arch.startswith("zamba2") else 0)
        assert all(c.k.shape == (1, 4096, 32, 64) for c in gqa)
        assert sum(c.state.shape[0] for c in ts
                   if isinstance(c, TSSM.Mamba2Cache)) == \
            (32 if arch.startswith("zamba2") else 48)
    assert nbytes["zamba2-1.2b"] < 500e6 and nbytes["mamba2-1.3b"] < 120e6


def test_one_step_and_a_checkpoint_of_the_hybrid(tmp_path):
    """``convert.lm_params`` of the reference's layout (``None`` groups)
    gives the port's tree back; one ``make_train_step`` step (AdamW) of
    zamba2-tiny at 7 layers: finite metrics, every parameter moved but the shared-attention groups
    (no leaves in the parameters, the moments or the checkpoint); the
    ``(params, opt_state)`` pair saved and restored bit for bit under the
    reference's names."""
    _, tc, _, tp = _pair("zamba2-1.2b")
    again = convert.lm_params(_reference_layout(tc, tp), tc, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))
    step, _ = make_train_step(tc, None, ShapeSpec("t", 24, 2, "train"),
                              AdamWConfig(), total_steps=10)
    _, tb = _tokens(tc)
    params, opt, metrics = step(tp, init_adamw(tp, step.opt), tb)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert int(opt.step) == 1
    plan = TM.group_plan(tc.layer_plan())
    for tree in (params, opt.m, opt.v):
        assert [g for g, (k, _) in zip(tree["groups"], plan)
                if k == "shared_attn"] == [{}, {}]
    moved = [n for (n, a), (_, b) in zip(named_leaves(tp),
                                         named_leaves(params))
             if not torch.equal(a, b)]
    assert len(moved) == len(named_leaves(tp))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, (params, opt))
    (p2, o2), man = mgr.restore(None, (params, opt))
    assert man["step"] == 0
    saved = named_leaves((params, opt))
    restored = named_leaves((p2, o2))
    assert [n for n, _ in saved] == [n for n, _ in restored]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(saved, restored))
    names = {n for n, _ in saved}
    assert {"0/shared_attn/attn/wq/w", "0/groups/2/mixer/in_proj/w",
            "1/m/shared_attn/mlp/up/w"} <= names
    assert not any(n.startswith(("0/groups/1/", "0/groups/3/"))
                   for n in names)


def test_each_cache_kind_has_its_own_write(monkeypatch):
    """A Mamba2 cache given to the GQA write (the rolling-slot write of a
    sequence buffer) raises instead of being written at a clamped slot;
    so does a GQA cache given to the mamba write. In a hybrid's decode
    each cache goes to its own kind's write."""
    _, tc, _, tp = _pair("zamba2-1.2b")
    caches = TM.init_caches(tc, 1, 16, device="cpu")
    mamba = next(c for c in caches if isinstance(c, TSSM.Mamba2Cache))
    gqa = next(c for c in caches if isinstance(c, TA.GQACache))
    before = [t.clone() for t in mamba]
    with pytest.raises(TypeError, match="Mamba2Cache"):
        TM._write_gqa(mamba, [(mamba.conv[0], mamba.conv[0])], None)
    assert all(torch.equal(a, b) for a, b in zip(before, mamba))
    with pytest.raises(TypeError, match="GQACache"):
        TM._write_mamba(TM._as_stack(gqa), [(gqa.k, gqa.v)])
    seen = []
    writes = {name: getattr(TM, name) for name in ("_write_gqa",
                                                    "_write_mamba")}

    def spy(name):
        def write(cache, *args):
            seen.append((name, type(cache).__name__))
            return writes[name](cache, *args)
        return write

    for name in writes:
        monkeypatch.setattr(TM, name, spy(name))
    with torch.no_grad():
        TM.decode_step(tp, tc, {"tokens": torch.zeros((1, 1),
                                                      dtype=torch.long)},
                       caches)
    assert sorted(set(seen)) == [("_write_gqa", "GQACache"),
                                 ("_write_mamba", "Mamba2Cache")]
    assert len(seen) == len(caches)
    assert all(int(c.length.reshape(-1)[0]) == 1 for c in caches)


def test_ssd_on_a_mesh_of_more_than_one_rank_raises(tmp_path):
    """The SSD on a mesh runs the context-parallel path it once refused
    (its worlds of 2 and 4 ranks are held against the reference in
    ``tests/test_torch_multicard.py``): under a 1 x 1 mesh context in a
    gloo world of this process alone, ``ssd_context_parallel`` equals the
    chunked SSD bit for bit, and ``train_loss`` of the ssm and hybrid
    tiny configs equals the mesh-less one."""
    import torch_sharded_worker as W
    from repro_torch.distributed import MeshContext, use_mesh_context
    from repro_torch.launch.mesh import make_local_mesh

    x, dt, A, Bm, Cm, _ = map(torch.tensor, _ssd_inputs(8))
    want = TSSM.ssd_chunked(x, dt, A, Bm, Cm, chunk=4)[0]
    assert torch.equal(TSSM.ssd_context_parallel(x, dt, A, Bm, Cm, chunk=4),
                       want)
    with W.world_of_one(tmp_path / "init"):
        ctx = MeshContext(make_local_mesh(1, 1, device="cpu"))
        with use_mesh_context(ctx):
            assert torch.equal(
                TSSM.ssd_context_parallel(x, dt, A, Bm, Cm, chunk=4), want)
        for arch in TINY:
            tc = get_config(arch).tiny(**F32)
            params = TM.init_params(tc, device="cpu")
            _, tb = _tokens(tc, B=1, S=8)
            plain, _ = TM.train_loss(params, tc, tb)
            with use_mesh_context(ctx):
                meshed, _ = TM.train_loss(params, tc, tb)
            assert float(meshed) == pytest.approx(float(plain), rel=1e-6)