"""repro_torch's encoder-decoder family (whisper-base) against the JAX
package, on the CPU: the cross-attention, one ``enc_attn`` and one
``dec_attn`` block (LayerNorm, the non-gated tanh-GELU MLP), ``forward``
and ``train_loss`` with every gradient (the encoder's, the learned
positions' and the cross-attention's among them), ``decode_step`` with
the same encoder K/V for five steps (from position 0, and across the end
of the position table), decode over K/V built from the encoder against
``forward``, ``prefill``, the caches and input specs of the three modes,
and the train and serve drivers.

Config: whisper-base's ``tiny()`` (2 encoder + 2 decoder layers, d 128,
vocab 512) in float32. Inputs are made from seeds with numpy; the
parameters are the reference's ``init_params``, carried to the port by
``convert.lm_params``. The reference runs under ``jax.jit``, its loss and
gradients once for the module. Tolerances are those of
``tests/test_torch_lm.py``: hidden states, logits and caches 1e-5 of max
|value|; ``ce`` 1e-5 and ``ot`` 1e-4 relative; gradients 1e-4 of each
model leaf's max |grad| and 1e-3 of each ``ot`` leaf's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.launch import specs as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import serve, train
from repro_torch.launch import specs as TS
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import linear
from repro_torch.tree import named_leaves, tree_leaves, tree_map, \
    tree_unflatten

ARCH = "whisper-base"
F32 = dict(param_dtype="float32", compute_dtype="float32")
HIDDEN_TOL = 1e-5        # of max |value|
CE_RTOL = 1e-5
OT_RTOL = 1e-4
GRAD_TOL = 1e-4          # of each model leaf's max |grad|
OT_GRAD_TOL = 1e-3       # of each ot leaf's max |grad|
B, S, T = 2, 12, 20      # batch, decoder tokens, encoder frames


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at the tiny
    widths torch's pool otherwise contends with XLA's on the same cores."""
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


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX tiny config, port tiny config, JAX params, port params)."""
    jc = j_get_config(ARCH).tiny(**F32)
    tc = get_config(ARCH).tiny(**F32)
    jp = jax.jit(lambda k: JM.init_params(k, jc))(jax.random.PRNGKey(0))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _batch(cfg, seed=0, S=S, T=T):
    """The pipeline's encdec batch: 0.02 N(0, 1) frames, tokens, labels."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1))
    emb = (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(
        np.float32)
    return ({"enc_embeds": jnp.asarray(emb),
             "tokens": jnp.asarray(tok[:, :-1], jnp.int32),
             "labels": jnp.asarray(tok[:, 1:], jnp.int32)},
            {"enc_embeds": torch.tensor(emb), "tokens": torch.tensor(
                tok[:, :-1]), "labels": torch.tensor(tok[:, 1:])})


@pytest.fixture(scope="module")
def reference_loss():
    """The reference's loss, metrics, hidden states and gradients on
    ``_batch``, one jitted trace: the hidden states are those its
    ``train_loss`` computes, read in the same trace (a second ``forward``
    would add to the compile)."""
    jc, _, jp, _ = _pair()
    jb, _ = _batch(jc)
    j_forward, seen = JM.forward, {}

    def spy(*args, **kw):
        seen["h"], aux = j_forward(*args, **kw)
        return seen["h"], aux

    def j_loss(p, b):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(JM, "forward", spy)
            loss, metrics = JM.train_loss(p, jc, b)
        return loss, (metrics, seen["h"])

    (lj, (mj, hj)), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, jb)
    return lj, mj, hj, dict(named_leaves(jax.tree.map(np.asarray, gj)))


@pytest.mark.parametrize("S_,T_,chunk", [(7, 13, 4), (9, 5, 1024)])
def test_cross_attention_matches_reference(S_, T_, chunk):
    """Decoder states of S_ tokens over T_ encoder frames (T_ != S_; 13
    frames in chunks of 4 leave a padded tail), 1e-5 of max |out|."""
    d, H, D = 32, 4, 8
    pj = JA.init_cross_attention(jax.random.PRNGKey(3), d, H, D)
    pt = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), pj)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S_, d)).astype(np.float32)
    enc = rng.standard_normal((2, T_, d)).astype(np.float32)
    kw = dict(n_heads=H, head_dim=D, kv_chunk=chunk)
    oj = jax.jit(functools.partial(JA.cross_attention, **kw))(
        pj, jnp.asarray(x), jnp.asarray(enc))
    ot = TA.cross_attention(pt, torch.tensor(x), torch.tensor(enc), **kw)
    assert ot.shape == (2, S_, d)
    assert _rel_to_max(ot.numpy(), oj) <= HIDDEN_TOL


@pytest.mark.parametrize("kind", ["enc_attn", "dec_attn"])
def test_block_matches_reference(kind):
    """One layer of each block kind (LayerNorm, the non-gated GELU MLP;
    bidirectional self-attention, or causal self-attention then the
    cross-attention over encoder states), 1e-5 of max |out|."""
    jc, tc, jp, tp = _pair()
    stack_j = jp["encoder"] if kind == "enc_attn" else jp["groups"][0]
    stack_t = tp["encoder"] if kind == "enc_attn" else tp["groups"][0]
    pj = jax.tree.map(lambda a: a[1], stack_j)
    pt = TM._unstack(stack_t, 2)[1]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, T, tc.d_model)).astype(np.float32)
    enc_j = jnp.asarray(enc) if kind == "dec_attn" else None
    yj, auxj = jax.jit(lambda p, x_, e: JM._block_train(kind, p, x_, jc,
                                                       enc=e))(
        pj, jnp.asarray(x), enc_j)
    with torch.no_grad():
        yt, auxt = TM._block_train(
            kind, pt, torch.tensor(x), tc,
            torch.tensor(enc) if kind == "dec_attn" else None)
    assert float(auxt) == float(auxj) == 0.0
    assert _rel_to_max(yt.numpy(), yj) <= HIDDEN_TOL


def test_forward_and_loss_match_reference(reference_loss):
    """Hidden states 1e-5 of max |value|; ``ce`` and the loss 1e-5, ``ot``
    1e-4 relative."""
    lj, mj, hj, _ = reference_loss
    _, tc, _, tp = _pair()
    _, tb = _batch(tc)
    with torch.no_grad():
        ht, aux = TM.forward(tp, tc, tb)
        lt, mt = TM.train_loss(tp, tc, tb)
    assert float(aux) == 0.0
    assert _rel_to_max(ht.numpy(), hj) <= HIDDEN_TOL
    assert set(mt) == set(mj) == {"ce", "aux", "ot", "loss"}
    assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), rel=CE_RTOL)
    assert float(mt["ot"]) == pytest.approx(float(mj["ot"]), rel=OT_RTOL)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=CE_RTOL)


def test_every_gradient_matches_reference(reference_loss):
    """Every leaf's gradient, the encoder's, ``pos`` and ``xattn`` among
    them, within its bar of the leaf's max |grad|."""
    want = reference_loss[3]
    _, tc, _, tp = _pair()
    _, tb = _batch(tc)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = TM.train_loss(tree_unflatten(tp, leaves), tc, tb)
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in named_leaves(tp)]
    assert set(names) == set(want)
    assert {"pos", "encoder/attn/wq/w", "enc_norm/b", "groups/0/xattn/wk/w",
            "groups/0/norm_x/w"} <= set(names)
    for name, g in zip(names, grads):
        tol = OT_GRAD_TOL if name.startswith("ot/") else GRAD_TOL
        assert _rel_to_max(g.numpy(), want[name]) <= tol, name
        assert float(g.abs().max()) > 0, name


def test_encoder_gradient_flows_only_through_the_cross_attention_kv():
    """With every decoder layer's ``xattn`` wk and wv zero, the decoder
    no longer reads the encoder: every encoder leaf's gradient and the
    frames' gradient are exactly zero (with them, none is)."""
    _, tc, _, tp = _pair()
    _, tb = _batch(tc)

    def grads(params):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        emb = tb["enc_embeds"].clone().requires_grad_(True)
        loss, _ = TM.train_loss(tree_unflatten(params, leaves), tc,
                                dict(tb, enc_embeds=emb))
        g = torch.autograd.grad(loss, leaves + [emb])
        named = dict(zip([n for n, _ in named_leaves(params)], g))
        return named, g[-1]

    cut = tree_map(lambda t: t, tp)
    xattn = dict(cut["groups"][0]["xattn"])
    for w in ("wk", "wv"):
        xattn[w] = {"w": torch.zeros_like(xattn[w]["w"])}
    cut["groups"][0] = dict(cut["groups"][0], xattn=xattn)
    for params, zero in ((tp, False), (cut, True)):
        named, g_emb = grads(params)
        enc = [g for n, g in named.items() if n.startswith(("encoder/",
                                                           "enc_norm/"))]
        assert len(enc) == 12
        assert all((float(g.abs().max()) == 0) == zero for g in enc)
        assert (float(g_emb.abs().max()) == 0) == zero


def _enc_kv(cfg, seed=4):
    kv = np.random.default_rng(seed).standard_normal(
        (cfg.n_layers, B, T, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    return ({"k": jnp.asarray(kv), "v": jnp.asarray(kv)},
            {"k": torch.tensor(kv), "v": torch.tensor(kv)})


def _pinned_rotary(positions, head_dim, theta=10000.0):
    """The reference's ``rotary_cos_sin`` with its frequencies computed
    once in numpy float32 (bit for bit the port's and eager JAX's) and
    baked into the trace: under ``jax.jit`` XLA rounds ``theta ** x``
    differently, and at positions near 65536 one ulp of a frequency moves
    an angle by ~8e-3 rad (65536 ulps of 1.0), far past the test's bar."""
    half = head_dim // 2
    freqs = np.float32(1.0) / (np.float32(theta) ** (
        np.arange(half, dtype=np.float32) / np.float32(half)))
    ang = positions.astype(jnp.float32)[..., None] * jnp.asarray(freqs)
    return jnp.cos(ang), jnp.sin(ang)


@functools.lru_cache(maxsize=None)
def _reference_step():
    """The reference's jitted ``decode_step``, traced once for both
    cases of the test (each with the rotation pinned)."""
    jc = _pair()[0]
    return jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c))


@pytest.mark.parametrize("start", [0, 65534])
def test_decode_matches_reference(start, monkeypatch):
    """Five ``decode_step`` calls with the same ``enc_kv`` (k = v, as the
    serve driver draws it), from caches whose ``length`` starts at
    ``start``: each step's logits and then every cache leaf 1e-5 of max
    |value|. From 65534 the learned position runs past the table's
    65536 rows, and both clamp it to the last row. The reference's
    rotation runs on pinned frequencies (``_pinned_rotary``)."""
    monkeypatch.setattr(JA, "rotary_cos_sin", _pinned_rotary)
    jc, tc, jp, tp = _pair()
    s_max = 8
    tok = np.random.default_rng(5).integers(0, jc.vocab, (B, 5))
    kv_j, kv_t = _enc_kv(tc)
    jcache = JM.init_caches(jc, B, s_max)
    jcache = [c._replace(length=c.length + start) for c in jcache]
    tcache = TM.init_caches(tc, B, s_max, device="cpu")
    for c in tcache:
        c.length.add_(start)
    jstep = _reference_step()
    with torch.no_grad():
        for i in range(5):
            lj, jcache = jstep(jp, {"tokens": jnp.asarray(
                tok[:, i:i + 1], jnp.int32), "enc_kv": kv_j}, jcache)
            lt, tcache = TM.decode_step(tp, tc, {"tokens": torch.tensor(
                tok[:, i:i + 1]), "enc_kv": kv_t}, tcache)
            assert lt.shape == (B, 1, tc.padded_vocab)
            assert _rel_to_max(_np(lt), lj) <= HIDDEN_TOL, i
    got, want = tree_leaves(tcache), jax.tree.leaves(jcache)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel_to_max(_np(g), w) <= HIDDEN_TOL
    assert tcache[0].length.tolist() == [start + 5] * tc.n_layers


def test_decode_over_encoder_kv_equals_forward():
    """K/V built from the encoder's output (each layer's ``xattn`` wk and
    wv), then the tokens teacher-forced through ``decode_step``: each
    position's logits 1e-5 of max |logit| against ``forward``'s."""
    _, tc, _, tp = _pair()
    _, tb = _batch(tc, seed=6)
    layers = TM._unstack(tp["groups"][0], tc.n_layers)
    caches = TM.init_caches(tc, B, S, device="cpu")
    with torch.no_grad():
        enc = TM._encode(tp, tc, tb)
        ref = TM._logits(tp, tc, TM.forward(tp, tc, tb)[0])
        kv = {w: torch.stack([
            linear(p_l["xattn"][f"w{w}"], enc).reshape(
                B, T, tc.n_heads, tc.head_dim) for p_l in layers])
            for w in ("k", "v")}
        for i in range(S):
            lt, caches = TM.decode_step(
                tp, tc, {"tokens": tb["tokens"][:, i:i + 1], "enc_kv": kv},
                caches)
            assert _rel_to_max(_np(lt[:, 0]), _np(ref[:, i])) <= HIDDEN_TOL, i


def test_prefill_matches_reference():
    """The last position's logits of the whole forward, encoder included,
    1e-5 of max |logit|."""
    jc, tc, jp, tp = _pair()
    jb, tb = _batch(jc, seed=7)
    jb.pop("labels"), tb.pop("labels")
    pj = jax.jit(lambda p, b: JM.prefill(p, jc, b))(jp, jb)
    with torch.no_grad():
        pt = TM.prefill(tp, tc, tb)
    assert pt.shape == (B, 1, tc.padded_vocab)
    assert _rel_to_max(pt.numpy(), pj) <= HIDDEN_TOL


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_specs_and_caches_match_reference(mode):
    """``launch.specs.input_specs`` (names, shapes, on ``meta``) and, for
    decode, ``init_caches`` of whisper-base at full size against the
    reference's ``input_specs`` / ``cache_specs``."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    js = JS.input_specs(jc, JShapeSpec("t", 1500, 4, mode))
    ts = TS.input_specs(tc, ShapeSpec("t", 1500, 4, mode))
    want = {n: tuple(s.shape) for n, s in named_leaves(js)}
    assert {n: tuple(t.shape) for n, t in named_leaves(ts)} == want
    assert all(t.is_meta for t in tree_leaves(ts))
    if mode == "decode":
        assert want["enc_kv/k"] == (6, 4, 1500, 8, 64)
        jcache = JS.cache_specs(jc, JShapeSpec("t", 1500, 4, mode))
        tcache = TS.cache_specs(tc, ShapeSpec("t", 1500, 4, mode))
        assert [tuple(t.shape) for t in tree_leaves(tcache)] == [
            tuple(s.shape) for s in jax.tree.leaves(jcache)]
        assert tcache[0].k.shape == (6, 4, 1500, 8, 64)


def test_train_driver_resumes_and_serve_driver_runs(tmp_path):
    """``launch.train`` on the tiny config: 3 steps with a checkpoint
    after steps 1 and 2; with step 2's commit dropped, ``--resume``
    restores step 1 and runs step 2 again with the same loss.
    ``launch.serve`` with the reference's random ``enc_kv`` generates its
    tokens."""
    ck = tmp_path / "ck"
    base = ["--arch", ARCH, "--tiny", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(ck),
            "--save-every", "2"]
    first = train.main(base + ["--steps", "3"])
    assert [d["step"] for d in first["losses"]] == [0, 1, 2]
    (ck / "step_000000002" / "COMMIT").unlink()
    again = train.main(base + ["--steps", "1", "--resume"])
    assert again["start"] == 2
    assert again["losses"][0]["loss"] == pytest.approx(
        first["losses"][2]["loss"], rel=1e-6)
    out = serve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out["generated"].shape == (2, 3)
    assert np.isfinite(out["decode_tok_s"])
