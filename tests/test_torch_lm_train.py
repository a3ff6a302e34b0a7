"""repro_torch's LM training surfaces on the CPU: AdamW and its schedule,
one ``make_train_step`` step and forty steps against the JAX package's,
the data pipeline, checkpoints, the training supervisor, the input specs
and the three drivers.

Tolerances: one ``adamw_update`` from the same gradients and state gives
parameters and moments within 1e-6 of each leaf's max |value| (float32
and bfloat16 moments); the schedule 1e-6 relative; one training step
with ``micro_batches=2`` gives ``ce`` 1e-5 and ``ot`` 1e-4 relative,
parameters within 1e-5 of each leaf's max |value| and moments within 1e-4
of theirs (the gradients' bar); forty steps hold their losses to the
bars stated in the test. The checkpoint and supervisor checks mirror
``tests/test_checkpoint.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import ShapeSpec as JShape
from repro.distributed import fault_tolerance as JFT
from repro.launch import specs as JS
from repro.launch.mesh import make_local_mesh as j_local_mesh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.distributed.fault_tolerance import (
    FaultToleranceConfig,
    TrainingSupervisor,
    remesh_plan,
    suggest_save_every,
)
from repro_torch.kernels.build import KernelError
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import abstract_state, make_serve_step, \
    make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw as TO
from repro_torch.tree import named_leaves, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
F32 = dict(param_dtype="float32", compute_dtype="float32")
OPT_TOL = 1e-6           # of each leaf's max |value|
STEP_PARAM_TOL = 1e-5    # of each leaf's max |value|
STEP_MOMENT_TOL = 1e-4


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(x):
    """A JAX or torch leaf as float64 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _leaves_agree(got, want, tol):
    want = dict(named_leaves(want))
    for name, leaf in named_leaves(got):
        assert _rel_to_max(_np(leaf), _np(want[name])) <= tol, name


def _tree_np(rng, tree):
    return tree_map(lambda t: rng.standard_normal(tuple(t.shape)).astype(
        np.float32), tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """One update at step 4 of a tiny smollm's parameters from the same
    gradients and moments, with clipping and the warmup-cosine schedule;
    the decay mask decays a stacked norm scale (2-D in the group) and not
    ``final_norm`` (1-D). The reference runs op by op here, not under
    ``jax.jit``: XLA fuses the jitted update into fused multiply-adds,
    whose float32 moments differ from the op-by-op ones by an ulp and so
    round to a neighbouring bfloat16 value in about 1 element in 10^3."""
    cfg = get_config("smollm-135m").tiny(**F32)
    rng = np.random.default_rng(0)
    meta = init_params(cfg, device="meta")
    p_np, g_np = _tree_np(rng, meta), _tree_np(rng, meta)
    m_np = _tree_np(rng, meta)
    v_np = tree_map(lambda a: np.abs(a), _tree_np(rng, meta))
    ocfg = TO.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    jcfg = JO.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    mdt = jnp.dtype(moment_dtype)
    jstate = JO.AdamWState(jnp.asarray(4, jnp.int32),
                           jax.tree.map(lambda a: jnp.asarray(a, mdt), m_np),
                           jax.tree.map(lambda a: jnp.asarray(a, mdt), v_np))
    jsched = JO.linear_warmup_cosine(1e-2, 3, 20)
    jp, js, jm = JO.adamw_update(
        jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, g_np),
        jstate, jcfg, lr_schedule=jsched)
    tparams = tree_map(torch.tensor, p_np)
    tstate = convert.adamw_state(jax.tree.map(np.asarray, jstate), tparams,
                                 device="cpu")
    assert tstate.m["final_norm"]["w"].dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    tp, ts, tm = TO.adamw_update(tparams, tree_map(torch.tensor, g_np),
                                 tstate, ocfg,
                                 lr_schedule=TO.linear_warmup_cosine(
                                     1e-2, 3, 20))
    assert int(ts.step) == int(js.step) == 5
    _leaves_agree(tp, jp, OPT_TOL)
    _leaves_agree(ts.m, js.m, OPT_TOL)
    _leaves_agree(ts.v, js.v, OPT_TOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    # the mask: with zero gradients and moments only the decay moves a leaf
    zero = tree_map(torch.zeros_like, tparams)
    st0 = TO.init_adamw(tparams, ocfg)
    moved, _, _ = TO.adamw_update(tparams, zero, st0, ocfg)
    norm1 = tparams["groups"][0]["norm1"]["w"]
    assert norm1.dim() == 2 and not torch.equal(
        moved["groups"][0]["norm1"]["w"], norm1)
    assert torch.equal(moved["final_norm"]["w"], tparams["final_norm"]["w"])


def test_schedules_match_reference():
    """``linear_warmup_cosine`` at step 0, the end of the warmup, past it
    and at the total; ``cosine_schedule`` past its end (clipped)."""
    t = TO.linear_warmup_cosine(3e-4, 20, 300)
    j = JO.linear_warmup_cosine(3e-4, 20, 300)
    for s in (0, 1, 20, 21, 150, 300):
        assert float(t(s)) == pytest.approx(float(j(jnp.asarray(s))),
                                            rel=1e-6, abs=1e-12), s
    assert float(t(0)) == 0.0 and float(t(20)) == pytest.approx(3e-4)
    c, jc = TO.cosine_schedule(1.0, 10), JO.cosine_schedule(1.0, 10)
    assert float(c(torch.tensor(15))) == pytest.approx(
        float(jc(jnp.asarray(15))), rel=1e-6)


def test_train_step_with_micro_batches_matches_reference():
    """One ``make_train_step`` step with ``micro_batches=2`` (two halves of
    a batch of 4 x 16, gradients summed then halved) from the same
    parameters and batch, against the reference's step on a 1 x 1 mesh:
    the metrics, the updated parameters and the moments. AdamW runs at
    eps = 1 and lr = 1, where its first update is close to linear in the
    clipped gradient, so the parameters hold the accumulated gradients to
    the gradients' bar (at eps = 1e-8 the first update is +-lr wherever
    |g| >> eps, and a gradient near zero may take either sign)."""
    kw = dict(F32, ot_iters=6)
    jc = j_get_config("smollm-135m").tiny(**kw)
    tc = get_config("smollm-135m").tiny(**kw)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, jc.vocab, (4, 17))
    batch_np = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    p_np = jax.tree.map(np.asarray, jp)
    jopt = JO.AdamWConfig(lr=1.0, eps=1.0)
    opt = TO.AdamWConfig(lr=1.0, eps=1.0)
    jstep, _, _ = j_make_train_step(jc, j_local_mesh(1, 1),
                                    JShape("t", 16, 4, "train"), opt=jopt,
                                    total_steps=50, micro_batches=2)
    jnew, jstate, jm = jstep(jax.tree.map(jnp.asarray, p_np),
                             JO.init_adamw(jp, jopt),
                             jax.tree.map(lambda a: jnp.asarray(a, jnp.int32),
                                          batch_np))
    tstep, (p_shape, o_shape, in_specs) = make_train_step(
        tc, None, ShapeSpec("t", 16, 4, "train"), opt=opt, total_steps=50,
        micro_batches=2)
    assert tstep.micro_batches == 2
    assert in_specs["tokens"].shape == (4, 16)
    tp = convert.lm_params(p_np, tc, device="cpu")
    tnew, tstate, tm = tstep(tp, TO.init_adamw(tp, opt),
                             {k: torch.tensor(v) for k, v in
                              batch_np.items()})
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    assert float(tm["ot"]) == pytest.approx(float(jm["ot"]), rel=1e-4)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _leaves_agree(tnew, jax.tree.map(np.asarray, jnew), STEP_PARAM_TOL)
    _leaves_agree(tstate.m, jax.tree.map(np.asarray, jstate.m),
                  STEP_MOMENT_TOL)
    # the inputs are left as they were: a step is functional
    _leaves_agree(tp, p_np, 0.0)


TRAJ_STEPS = 40
TRAJ_EARLY = 5           # the warmup steps
TRAJ_EARLY_OT_RTOL = 1e-2
TRAJ_CE_RTOL = 2e-3      # every step's ce, relative
TRAJ_OT_RTOL = 0.25      # every step's ot, relative
TRAJ_OT_MEAN_RTOL = 3e-2  # the mean ot of the last half, relative


@pytest.fixture
def one_torch_thread():
    """One torch thread for the test, restored after it: at the tiny
    widths the port's steps are op-overhead bound, and torch's pool
    otherwise contends with XLA's on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_trajectory_follows_reference(one_torch_thread):
    """Forty ``make_train_step`` steps at the tiny config's widths
    (d_model 128, 4 heads, 2 KV heads, d_ff 256, two layers, a
    vocabulary of 512) and its OT loss (64 of 4 x 32 tokens against 64
    prototypes, r = 33, 10 iterations), with the default AdamW and
    schedule, against the reference's steps (its jitted step, scanned
    over the batches in one compiled call) from the same weights (the
    port's seeded draw, carried into the reference's pytree) and the
    port's data stream. It holds what one step cannot: the moments, the
    step count and the prototypes carried across steps. Each package
    rounds the OT factors to bf16, so the parameters' last bits differ
    after the first update and training amplifies them. Step 0 is held at
    one step's bars (``ce`` 1e-5, ``ot`` 1e-4 relative), the warmup steps
    at ``ce`` 1e-5 and ``ot`` 1e-2, every step at ``ce`` 2e-3 and ``ot``
    0.25, and the mean ``ot`` of the last 20 steps at 3e-2 (at this seed
    the gaps are 0 and 5e-7 at step 0, 1.5e-7 and 1.4e-4 in the warmup,
    1.8e-5 and 1.4e-2 over all steps, and 7.3e-4 for the mean)."""
    jc = j_get_config("smollm-135m").tiny(**F32)
    tc = get_config("smollm-135m").tiny(**F32)
    B, S = 4, 32
    data = DataPipeline(DataConfig(0, B, S, tc.vocab), device="cpu")
    batches = [data.batch_at(step) for step in range(TRAJ_STEPS)]
    tp = init_params(tc, seed=0, device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jstep, _, _ = j_make_train_step(jc, j_local_mesh(1, 1),
                                    JShape("t", S, B, "train"),
                                    opt=JO.AdamWConfig(),
                                    total_steps=TRAJ_STEPS)

    def j_trajectory(state, stacked):
        """The reference's steps in one compiled scan over the batches."""
        def body(carry, batch):
            *carry, m = jstep(*carry, batch)
            return tuple(carry), jnp.stack([m["ce"], m["ot"]])
        return jax.lax.scan(body, state, stacked)[1]

    stacked = {k: jnp.asarray(np.stack([b[k].numpy() for b in batches]),
                              jnp.int32) for k in batches[0]}
    ref = np.asarray(jax.jit(j_trajectory)(
        (jp, JO.init_adamw(jp, JO.AdamWConfig())), stacked))
    tstep, _ = make_train_step(tc, None, ShapeSpec("t", S, B, "train"),
                               opt=TO.AdamWConfig(), total_steps=TRAJ_STEPS)
    tstate = (tp, TO.init_adamw(tp, tstep.opt))
    rows = []
    for step in range(TRAJ_STEPS):
        *tstate, tm = tstep(*tstate, batches[step])
        rows.append(list(ref[step]) + [float(tm[k]) for k in ("ce", "ot")])
    rows = np.array(rows)          # (steps, [ref ce, ref ot, ce, ot])
    rel = np.abs(rows[:, 2:] - rows[:, :2]) / np.abs(rows[:, :2])
    tail = rows[TRAJ_STEPS // 2:]
    ot_mean = abs(tail[:, 3].mean() / tail[:, 1].mean() - 1)
    print(f"\nref ce {rows[0, 0]:.6f} -> {rows[-1, 0]:.6f}, ot "
          f"{rows[0, 1]:.6f} -> mean {tail[:, 1].mean():.6f} over steps "
          f"{TRAJ_STEPS // 2}-{TRAJ_STEPS - 1} (max {rows[:, 1].max():.6f});"
          f" port ce {rows[0, 2]:.6f} -> {rows[-1, 2]:.6f}, ot "
          f"{rows[0, 3]:.6f} -> mean {tail[:, 3].mean():.6f}; worst rel "
          f"ce {rel[:, 0].max():.3g} ot {rel[:, 1].max():.3g} (steps < "
          f"{TRAJ_EARLY}: {rel[:TRAJ_EARLY, 0].max():.3g} / "
          f"{rel[:TRAJ_EARLY, 1].max():.3g}); mean ot rel {ot_mean:.3g}")
    assert rel[0, 0] <= 1e-5 and rel[0, 1] <= 1e-4
    assert rel[:TRAJ_EARLY, 0].max() <= 1e-5
    assert rel[:TRAJ_EARLY, 1].max() <= TRAJ_EARLY_OT_RTOL
    assert rel[:, 0].max() <= TRAJ_CE_RTOL
    assert rel[:, 1].max() <= TRAJ_OT_RTOL
    assert ot_mean <= TRAJ_OT_MEAN_RTOL


def test_meshes_beyond_one_card_are_refused(tmp_path):
    """Meshes and ``ot_shard=True`` run the paths they once refused (the
    worlds of 2 and 4 ranks are held against the reference in
    ``tests/test_torch_multicard.py``): in a gloo world of this process
    alone, a step on a 1 x 1 mesh with ``ot_shard=True`` (the OT loss on
    the sharded log plan) equals the mesh-less step (both solving in
    float32), and a decode on the mesh equals the mesh-less one. Only
    ``ot_shard=True`` without a mesh is refused."""
    import torch_sharded_worker as W
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import gather_tree, shard_tree
    from repro_torch.models import init_caches, shard_caches

    cfg = get_config("smollm-135m").tiny(**F32, ot_iters=4,
                                         ot_precision="highest")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(dataclasses.replace(cfg, ot_shard=True))
    params = init_params(cfg, device="cpu")
    tok = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (4, 17)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = TO.AdamWConfig(lr=1.0, eps=1.0)
    shape = ShapeSpec("t", 16, 4, "train")
    one, _ = make_train_step(cfg, None, shape, opt)
    want_p, _, want = one(params, TO.init_adamw(params, opt), batch)
    dshape = ShapeSpec("d", 16, 4, "decode")
    dec_one, _ = make_serve_step(cfg, None, dshape)
    want_logits, _ = dec_one(params, {"tokens": tok[:, :1]},
                             init_caches(cfg, 4, 16, device="cpu"))
    with W.world_of_one(tmp_path / "init"):
        mesh = make_local_mesh(1, 1, device="cpu")
        step, _ = make_train_step(dataclasses.replace(cfg, ot_shard=True),
                                  mesh, shape, opt)
        specs = step.shardings[0]
        shards = shard_tree(params, specs, step.context)
        new, _, got = step(shards, TO.init_adamw(shards, opt), batch)
        got_p = gather_tree(new, specs, step.context)
        dec, _ = make_serve_step(cfg, mesh, dshape)
        logits, _ = dec(shard_tree(params, specs, dec.context),
                        {"tokens": tok[:, :1]},
                        shard_caches(cfg, init_caches(cfg, 4, 16,
                                                      device="cpu"),
                                     dec.context))
    assert float(got["ce"]) == pytest.approx(float(want["ce"]), rel=1e-5)
    assert float(got["ot"]) == pytest.approx(float(want["ot"]), rel=1e-4)
    _leaves_agree(got_p, tree_map(lambda t: t.numpy(), want_p),
                  STEP_PARAM_TOL)
    assert _rel_to_max(_np(logits), _np(want_logits)) <= 1e-6


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-3-4b",
                                  "internvl2-26b"])
def test_specs_and_abstract_state_match_reference(arch):
    """Input specs of every mode and the decode caches, as ``meta``
    tensors of the reference's shapes (tokens int64 in the port), and the
    abstract state's parameter and moment shapes."""
    jc, tc = j_get_config(arch).tiny(), get_config(arch).tiny()
    for mode, seq in (("train", 32), ("prefill", 32), ("decode", 128)):
        js = JS.input_specs(jc, JShape("c", seq, 2, mode))
        ts = TS.input_specs(tc, ShapeSpec("c", seq, 2, mode))
        assert set(js) == set(ts)
        for k in js:
            assert tuple(ts[k].shape) == tuple(js[k].shape), (mode, k)
            assert ts[k].is_meta
    jcache = JS.cache_specs(jc, JShape("c", 128, 2, "decode"))
    tcache = TS.cache_specs(tc, ShapeSpec("c", 128, 2, "decode"))
    for jl, tl in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        assert tuple(tl.shape) == tuple(jl.shape) and tl.is_meta
    p_shape, o_shape = abstract_state(tc, TO.AdamWConfig())
    assert all(t.is_meta for t in tree_leaves((p_shape, o_shape.m)))
    assert [tuple(t.shape) for t in tree_leaves(o_shape.v)] == \
        [tuple(t.shape) for t in tree_leaves(p_shape)]


def test_data_pipeline_is_pure_in_the_step():
    cfg = DataConfig(seed=3, global_batch=4, seq_len=16, vocab=97)
    pipe = DataPipeline(cfg, device="cpu")
    a, b = pipe.batch_at(5), DataPipeline(cfg, device="cpu").batch_at(5)
    for k in ("tokens", "labels"):
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.int64
    assert not torch.equal(a["tokens"], pipe.batch_at(6)["tokens"])
    # labels are the tokens shifted left by one
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 97 and int(a["tokens"].min()) >= 0
    it = pipe.iterate(5)
    assert torch.equal(next(it)["tokens"], a["tokens"])
    # the Markov copy: a token is its left neighbour's draw plus 1 with
    # probability 1/2, and that neighbour kept its draw with probability
    # 1/2, so about a quarter follow their left neighbour
    big = DataPipeline(DataConfig(0, 64, 256, 1000), device="cpu").batch_at(0)
    t = big["tokens"]
    share = float(((t[:, 1:] == (t[:, :-1] + 1) % 1000).float()).mean())
    assert 0.22 < share < 0.28
    emb = DataPipeline(DataConfig(0, 2, 8, 50, input_kind="embeds",
                                  d_model=12), device="cpu").batch_at(1)
    assert set(emb) == {"embeds", "labels"} and emb["embeds"].shape == \
        (2, 8, 12)


def _tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g).to(dtype),
            "b": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                  "s": torch.zeros((), dtype=torch.int32)}}


def test_checkpoint_roundtrip_layout_and_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(dtype=torch.bfloat16)
    mgr.save(7, t, extra={"note": "x"})
    step_dir = tmp_path / "step_000000007"
    assert sorted(os.listdir(step_dir)) == ["COMMIT", "manifest.json",
                                            "shard_0.npz"]
    with np.load(step_dir / "shard_0.npz") as data:
        assert sorted(data.files) == ["a", "b/s", "b/w"]
        assert data["a"].dtype == np.float32       # bf16 widened
    restored, man = mgr.restore(None, tree_map(torch.zeros_like, t))
    assert man["step"] == 7 and man["extra"] == {"note": "x"}
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]        # step 1 garbage-collected


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree())
    os.makedirs(tmp_path / "step_000000004")       # a crash mid-save
    os.makedirs(tmp_path / "step_000000005.tmp")
    assert mgr.latest_step() == 3


def test_async_save_snapshots_before_the_thread(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree()
    mgr.save(2, t)
    t["a"].add_(1.0)               # a later in-place change is not saved
    mgr.wait()
    assert mgr.latest_step() == 2
    restored, _ = mgr.restore(2, _tree(seed=1))
    assert torch.equal(restored["a"], _tree()["a"])


def test_supervisor_recovers_from_failure(tmp_path):
    """A failure at step 7 restores the step-4 checkpoint and replays to
    the same final state; a kernel fault is re-raised, not restored."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    sup = TrainingSupervisor(mgr, FaultToleranceConfig(save_every=5,
                                                       max_restarts=3))
    fail = {"armed": True}

    def step_fn(state, step):
        if step == 7 and fail["armed"]:
            fail["armed"] = False
            raise RuntimeError("simulated node failure")
        return tree_map(lambda x: x + step, state)

    final, end = sup.run({"x": torch.zeros(3)}, 0, 10, step_fn)
    assert sup.restarts == 1 and end == 10
    assert torch.equal(final["x"], torch.full((3,), float(sum(range(10)))))
    assert sup.straggler_report()["flagged"] in (True, False)

    def faulty(state, step):
        raise KernelError("log_halfstep: launch failed")

    sup2 = TrainingSupervisor(mgr, FaultToleranceConfig(save_every=5))
    with pytest.raises(KernelError):
        sup2.run({"x": torch.zeros(3)}, 0, 3, faulty)
    assert sup2.restarts == 0


def test_admit_step_reads_tensors_and_bounds_the_streak(tmp_path):
    sup = TrainingSupervisor(CheckpointManager(str(tmp_path)),
                             FaultToleranceConfig(max_consecutive_skips=2))
    assert sup.admit_step({"loss": torch.tensor(1.0), "tag": "x"})
    assert not sup.admit_step({"loss": torch.tensor(float("nan"))})
    assert not sup.admit_step({"ot": torch.tensor([1.0, float("inf")])})
    with pytest.raises(RuntimeError, match="consecutive"):
        sup.admit_step({"loss": torch.tensor(float("nan"))})
    assert sup.skipped_steps == 3


def test_remesh_plan_and_save_interval_match_reference():
    for pods, per in ((2, 256), (1, 256), (1, 64), (1, 8)):
        assert remesh_plan(pods, per) == JFT.remesh_plan(pods, per)
    args = dict(step_time_s=1.0, ckpt_time_s=30.0, node_mtbf_h=1000.0,
                n_nodes=1000)
    assert suggest_save_every(**args) == JFT.suggest_save_every(**args)


def test_train_driver_resumes_from_its_checkpoint(tmp_path):
    """``launch.train --tiny --device cpu --steps 4 --ckpt-dir`` then
    ``--resume``: the second run starts past the latest committed step and
    replays the first run's losses from there."""
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    base = ["--arch", "smollm-135m", "--tiny", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--save-every", "2"]
    first = train.main(base + ["--steps", "4", "--ckpt-dir", ck])
    assert first["end"] == 4 and len(first["losses"]) == 4
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [1, 3]
    assert all(np.isfinite(m["loss"]) for m in first["losses"])
    # drop the last commit: the resume restores step 1 and replays steps
    # 2 and 3 (same data, same schedule) before going on
    (Path(ck) / "step_000000003" / "COMMIT").unlink()
    again = train.main(base + ["--steps", "4", "--ckpt-dir", ck,
                               "--resume"])
    assert again["start"] == 2 and again["end"] == 6
    assert [m["loss"] for m in again["losses"][:2]] == pytest.approx(
        [m["loss"] for m in first["losses"][2:]], rel=1e-6)


def test_train_lm_strict_runs_on_the_cpu(tmp_path):
    """``examples.train_lm --tiny --strict --device cpu --steps 6``: the
    fused plan at bf16 for the OT loss, finite losses, no skipped step and
    no capture after the warm-up."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--tiny", "--strict", "--device", "cpu",
                         "--steps", "6", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path / "lm")])
    assert out["end"] == 6 and out["skipped"] == 0 and out["captures"] == 0
    sel = [e for e in out["plan_events"]
           if e["geometry"] == "FactoredPositive"]
    assert len(sel) == 3 and all(e["precision"] == "bf16" for e in sel)
    assert "pallas=on" in out["policy"]


def test_serve_driver_runs_as_a_module():
    """``python -m repro_torch.launch.serve --tiny --device cpu`` exits 0
    and prints the prefill and decode lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
         "--device", "cpu", "--prompt-len", "8", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] device=cpu prefill: 4x8 tokens" in out.stdout
    assert "generated (4, 4)" in out.stdout


def test_serve_driver_greedy_tokens_follow_the_logits():
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_caches
    cfg = dataclasses.replace(get_config("smollm-135m").tiny(), **F32)
    out = serve.main(["--tiny", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3"])
    caches = init_caches(cfg, 2, 8, device="cpu")
    seq = torch.cat([out["prompt"], out["generated"]], dim=1)
    with torch.no_grad():
        for i in range(7):
            logits, caches = decode_step(out["params"], cfg,
                                         {"tokens": seq[:, i:i + 1]}, caches)
            if i >= 4:
                assert torch.equal(torch.argmax(logits[:, -1], -1),
                                   seq[:, i + 1])


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPipeline(DataConfig(0, 2, 8, 50))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "smollm-135m", "--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params({}, cfg)
