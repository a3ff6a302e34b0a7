"""repro_torch's multi-card LM surfaces over torch.distributed, against the
JAX package's multi-device runs, on the CPU.

One module-scoped fixture starts, together: gloo worlds of 1, 2 and 4
processes (``tests/torch_multicard_worker.py``, one torch thread a rank,
a 60 s process-group timeout), and four subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` that compute the
JAX package's results once (``tests/torch_multicard_reference.py``, in
four parts side by side). The same
numpy inputs, made from seeds, go to both sides; the train steps start
from the reference's own initial parameters. Each test asserts one case,
so each still counts; a world whose rank fails is killed at once and
fails its tests, and every wait has a deadline.

Bars: the sharding specs equal leaf for leaf; the int8 quantization, its
error feedback and ``compressed_psum`` bit-equal; the expert-parallel MoE
with drops (capacity factor 1.25) keeps the same (token, expert) set as a
recount of the reference's rule on its dispatch, its output within 1e-5
of max |out| and its gradients within 1e-5 of each one's max; the SSD's
context parallelism within 1e-5 of max |y| of the reference's and of the
chunked SSD; one train step on each rank's block of the batch (its rows,
its segment of the sequence) at ``tests/test_torch_lm_train.py``'s bars
(``ce`` 1e-5 and ``ot`` 1e-4 relative, parameters 1e-5 of each leaf's
max after AdamW at lr 1 and eps 1, float32 moments 1e-4 of max, bfloat16
moments one bf16 step, 2^-7 of max), every rank's gathered parameters
bit-equal, and a batch that does not divide over the data axis equal to
the step with no mesh; a decode and a prefill on a mesh within 1e-5 of
max |logit| of one rank's;
a resumed ``launch.train --mesh 2x1`` equal to the uninterrupted run;
``launch.train`` on its default 1x1 mesh, with drops, equal to the
reference's driver at the step bars.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as JSH
from repro.optim import compression as JC
from repro_torch.configs import get_config
from repro_torch.distributed import (
    PartitionSpec,
    logical_spec,
    shard,
    use_mesh_context,
)
from repro_torch.distributed.sharding import resolve_logical
from repro_torch.configs import ShapeSpec
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import abstract_state
from repro_torch.optim import compression as TC
from repro_torch.tree import named_leaves, tree_leaves

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import torch_multicard_worker as W  # noqa: E402

SRC = TESTS.parent / "src"
WORLDS = (1, 2, 4)
PARTS = ("a", "b", "c", "d")     # the reference's processes
DEADLINE_S = 420
ARCHS = ("deepseek_7b", "deepseek_v2_236b", "deepseek_v3_671b",
         "h2o_danube3_4b", "internvl2_26b", "mamba2_1p3b", "qwen2_1p5b",
         "smollm_135m", "whisper_base", "zamba2_1p2b")
SPEC_MESHES = ((1, 1), (2, 2), (4, 2))
PARAM_TOL = 1e-5          # of each leaf's max |value|
MOMENT_TOL = 1e-4         # float32 moments
BF16_MOMENT_TOL = 2.0 ** -7
EP_TOL = 1e-5
SSD_TOL = 1e-5
DECODE_TOL = 1e-5


def _finish(procs, deadline):
    """Wait for every process until ``deadline``; at the first failure (or
    the deadline) kill the rest. Returns the failed index or None."""
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        if bad or all(c == 0 for c in codes):
            break
        time.sleep(0.05)
    else:
        bad = [-1]
    if bad:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
        return bad[0]
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {part: results}, world: [rank results] or failure text}."""
    tmp = tmp_path_factory.mktemp("multicard")
    path = os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    jenv = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    logs, procs = [], {}
    for part in PARTS:
        log = open(tmp / f"ref_{part}.txt", "w")
        logs.append(log)
        procs[part] = [subprocess.Popen(
            [sys.executable, str(TESTS / "torch_multicard_reference.py"),
             part, str(tmp)], env=jenv, stdout=log,
            stderr=subprocess.STDOUT)]
    for p in WORLDS:
        procs[p] = []
        for r in range(p):
            log = open(tmp / f"log{p}_{r}.txt", "w")
            logs.append(log)
            procs[p].append(subprocess.Popen(
                [sys.executable, str(TESTS / "torch_multicard_worker.py"),
                 str(r), str(p), str(tmp / f"init{p}"),
                 str(tmp / f"out{p}_{r}.pt"), str(tmp)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DEADLINE_S
    out = {"ref": {}}
    try:
        for key in PARTS + WORLDS:
            bad = _finish(procs[key], deadline)
            if key in PARTS:
                if bad is None:
                    with open(tmp / f"ref_{key}.pkl", "rb") as fh:
                        out["ref"][key] = pickle.load(fh)
                else:
                    out["ref"][key] = (tmp / f"ref_{key}.txt").read_text()
                continue
            if bad is None:
                out[key] = [torch.load(tmp / f"out{key}_{r}.pt",
                                       weights_only=False)
                            for r in range(key)]
                continue
            errs = [(tmp / f"out{key}_{r}.pt.err") for r in range(key)]
            text = [e.read_text() for e in errs if e.exists()]
            out[key] = (f"world {key}, rank {bad}: " + (
                "\n".join(text) if text else (
                    tmp / f"log{key}_{max(bad, 0)}.txt").read_text()[-4000:]))
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
        for log in logs:
            log.close()
    return out


def _ref(runs, part):
    got = runs["ref"].get(part)
    if not isinstance(got, dict):
        pytest.fail(f"the reference's part {part} failed:\n{got}")
    return got


def _world(runs, world):
    got = runs[world]
    if isinstance(got, str):
        pytest.fail(got)
    return got


def _rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# logical axes and shardings
# ---------------------------------------------------------------------------


def test_logical_axes_resolve_as_the_reference():
    """``resolve_logical`` maps every logical axis as the reference's
    ``MeshContext.resolve`` on a 2-d and a 3-d mesh; without a context
    ``logical_spec`` is None and ``shard`` returns its input; an unknown
    axis raises ``KeyError``."""
    devs = np.array(jax.devices()[:1])
    for names in (("data", "model"), ("pod", "data", "model")):
        jctx = JSH.MeshContext(jax.sharding.Mesh(
            devs.reshape((1,) * len(names)), names))
        for logical in (None, "batch", "seq", "kvseq", "vocab", "expert",
                        "heads", "fsdp"):
            assert resolve_logical(logical, names) == jctx.resolve(logical)
        with pytest.raises(KeyError):
            resolve_logical("rows", names)
    x = torch.zeros(2, 3)
    assert logical_spec("batch", None) is None
    assert shard(x, "batch", None) is x
    assert PartitionSpec(None, "data") == (None, "data")
    with use_mesh_context(None):
        assert logical_spec("seq") is None


def test_a_layers_recomputation_runs_under_its_forwards_mesh_context(
        monkeypatch):
    """A checkpointed layer recomputes under the context its forward ran
    under, also when the backward runs on another thread after the
    context has closed (autograd runs a CUDA backward on threads of its
    own); the context is the process's, seen from every thread."""
    import threading
    from repro_torch.distributed import current_mesh_context
    from repro_torch.models import model as M
    seen = []

    def block(kind, p, x, cfg, enc):
        seen.append(current_mesh_context())
        return x * p["w"], torch.zeros(())
    monkeypatch.setattr(M, "_block_train", block)
    ctx = object()
    w = torch.ones(3, requires_grad=True)
    with use_mesh_context(ctx):
        out, _ = M._run_layer("attn", {"w": w}, torch.ones(3), None, None,
                              remat=True)
        other = []
        t = threading.Thread(target=lambda: other.append(
            current_mesh_context()))
        t.start()
        t.join()
    assert other == [ctx]
    t = threading.Thread(target=lambda: out.sum().backward())
    t.start()
    t.join()
    assert seen == [ctx, ctx]
    assert w.grad is not None and current_mesh_context() is None


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_reference(runs, arch, mesh):
    """``param_shardings``, ``input_shardings`` (train, prefill, decode)
    and ``cache_shardings`` equal the reference's ``PartitionSpec``s leaf
    by leaf (padded with ``None`` to each leaf's rank)."""
    want = _ref(runs, "b")["specs"][(arch, *mesh)]
    sizes = {"data": mesh[0], "model": mesh[1]}
    cfg = get_config(arch)
    p_shape, _ = abstract_state(cfg)
    got = dict(zip((n for n, _ in named_leaves(p_shape)),
                   tree_leaves(TS.param_shardings(sizes, cfg, p_shape))))
    assert {n: tuple(s) for n, s in got.items()} == want["params"]
    S, B = 256, 8
    for mode in ("train", "prefill", "decode"):
        sh = ShapeSpec("x", S, B, mode)
        ins = TS.input_shardings(sizes, cfg, sh, TS.input_specs(cfg, sh))
        flat = {}
        for k, v in ins.items():
            if isinstance(v, dict):
                flat.update({f"{k}/{kk}": tuple(vv) for kk, vv in v.items()})
            else:
                flat[k] = tuple(v)
        assert flat == want["inputs"][mode], mode
    dec = ShapeSpec("d", S, B, "decode")
    caches = [(tuple(leaf.shape), tuple(spec))
              for c, cs in zip(TS.cache_specs(cfg, dec),
                               TS.cache_shardings(sizes, cfg, dec))
              for leaf, spec in zip(c, cs)]
    assert caches == want["caches"]


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_int8_quantization_and_error_feedback_are_bit_equal():
    """``quantize_int8``, ``dequantize_int8`` and ``ef_compress_tree``
    (two steps, the error carried) give the reference's bits, on sizes
    that pad a last block and on values that round half to even."""
    rng = np.random.default_rng(0)
    for shape in ((1000,), (3, 256), (7, 13)):
        x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        x.reshape(-1)[:4] = [0.5, -1.5, 2.5, 127.0]
        jq = JC.quantize_int8(jnp.asarray(x))
        tq = TC.quantize_int8(torch.tensor(x))
        assert tq.n == jq.n
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        np.testing.assert_array_equal(
            TC.dequantize_int8(tq, shape).numpy(),
            np.asarray(JC.dequantize_int8(jq, shape)))
    grads = {"a": rng.standard_normal((300,)).astype(np.float32),
             "b": rng.standard_normal((4, 70)).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.tensor(v) for k, v in grads.items()}
    je, te = JC.init_error_buffers(jg), TC.init_error_buffers(tg)
    for _ in range(2):
        jd, je = JC.ef_compress_tree(jg, je)
        td, te = TC.ef_compress_tree(tg, te)
        for k in grads:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_reference(runs, world):
    """Every rank's ``compressed_psum`` equals the reference's
    ``shard_map`` bit for bit, and stays within the reference's bar of
    the exact sum (0.05 of its max plus 1e-3)."""
    want = _ref(runs, "b")["compress"][world]
    ranks = _world(runs, world)
    exact = W.compress_inputs(world).sum(0)
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["compress"], want[r:r + 1])
        err = np.abs(rank["compress"][0] - exact).max()
        assert err < 0.05 * np.abs(exact).max() + 1e-3


# ---------------------------------------------------------------------------
# expert parallelism and the SSD's context parallelism
# ---------------------------------------------------------------------------


def _capacity(rows, buckets, factor):
    c = int(-(-rows // max(buckets, 1)) * factor)
    return max(8, ((c + 7) // 8) * 8)


def _recount(idx, n_experts, factor):
    """The (token, expert) assignments the capacity rule keeps, recounted
    from every rank's dispatch (R, T, k): a send bucket a destination
    rank in (token, k) order, then each expert's rows in received order
    (by source rank, then slot)."""
    R, T, k = idx.shape
    e_loc = n_experts // R
    c_send = _capacity(T * k, R, factor)
    c_exp = _capacity(R * c_send, e_loc, factor)
    kept = np.zeros((R, T * k), bool)
    received = [[] for _ in range(R)]
    for src in range(R):
        sent = np.zeros(R, int)
        for a, e in enumerate(idx[src].reshape(-1)):
            dest = e // e_loc
            if sent[dest] < c_send:
                received[dest].append((src, sent[dest], e % e_loc, a))
            sent[dest] += 1
    for dest in range(R):
        taken = np.zeros(e_loc, int)
        for src, _, e, a in sorted(received[dest]):
            kept[src, a] = taken[e] < c_exp
            taken[e] += 1
    return kept.reshape(R, T, k)


@pytest.mark.parametrize("router", W.EP_ROUTERS)
@pytest.mark.parametrize("world", WORLDS)
def test_moe_ep_matches_reference(runs, world, router):
    """``moe_ep_local`` on ``"model"`` worlds of 1, 2 and 4 against the
    reference's ``shard_map`` expert parallelism on skewed tokens at
    capacity factor 1.25: the kept (token, expert) set equals a recount
    of the capacity rule on the reference's dispatch (and drops some),
    the output, aux and the gradients of every rank's experts, the
    router (summed over the ranks) and the tokens agree."""
    want = _ref(runs, "b")["ep"][(world, router)]
    ranks = [rank["ep"][router] for rank in _world(runs, world)]
    kept = _recount(want["idx"], W.EP["E"], W.EP["capacity_factor"])
    got_kept = np.stack([rank["kept"] for rank in ranks])
    np.testing.assert_array_equal(got_kept, kept)
    assert not kept.all()
    out = np.concatenate([rank["out"] for rank in ranks])
    assert _rel_to_max(out, want["out"]) <= EP_TOL
    assert all(abs(rank["aux"] - want["aux"]) <= EP_TOL * abs(want["aux"])
               for rank in ranks)
    g = want["grads"]
    assert _rel_to_max(np.concatenate([r["grads"]["x"] for r in ranks]),
                       g["x"]) <= EP_TOL
    assert _rel_to_max(sum(r["grads"]["router"] for r in ranks),
                       g["router"]) <= EP_TOL
    for k in ("up", "gate", "down"):
        assert _rel_to_max(np.concatenate([r["grads"][k] for r in ranks]),
                           g[k]) <= EP_TOL, k


@pytest.mark.parametrize("world", [2, 4])
def test_ssd_context_parallel_matches_reference(runs, world):
    """The SSD with the sequence over 2 and 4 ``"model"`` ranks equals the
    reference's context parallelism and the chunked SSD on every rank;
    its gradient (the ranks' summed over ranks, each rank holding the
    whole loss) is the chunked SSD's."""
    want = _ref(runs, "b")["ssd"]
    ranks = _world(runs, world)
    x, dt, A, Bm, Cm, cot = (torch.tensor(a) for a in W.ssd_inputs())
    from repro_torch.models.ssm import ssd_chunked
    x.requires_grad_(True)
    y1, _ = ssd_chunked(x, dt, A, Bm, Cm, chunk=W.SSD["chunk"])
    (gx,) = torch.autograd.grad(torch.sum(y1 * cot), [x])
    for rank in ranks:
        assert _rel_to_max(rank["ssd"]["y"], want[world]) <= SSD_TOL
        assert _rel_to_max(rank["ssd"]["y"], want["chunked"]) <= SSD_TOL
    summed = sum(rank["ssd"]["gx"] for rank in ranks) / world
    assert _rel_to_max(summed, gx.numpy()) <= SSD_TOL


# ---------------------------------------------------------------------------
# train steps, decode, the driver
# ---------------------------------------------------------------------------


def _step_agrees(got, want, cfg_zero3):
    for k in ("ce", "aux", "loss", "mtp"):
        if k in want["metrics"]:
            assert got["metrics"][k] == pytest.approx(
                want["metrics"][k], rel=1e-5, abs=1e-7), k
    assert got["metrics"]["ot"] == pytest.approx(want["metrics"]["ot"],
                                                 rel=1e-4)
    assert got["metrics"]["lr"] == pytest.approx(want["metrics"]["lr"],
                                                 rel=1e-6)
    assert set(got["params"]) == set(want["params"])
    for name, leaf in got["params"].items():
        assert _rel_to_max(leaf, want["params"][name]) <= PARAM_TOL, name
    tol = BF16_MOMENT_TOL if cfg_zero3 else MOMENT_TOL
    for name, leaf in got["m"].items():
        assert _rel_to_max(leaf, want["m"][name]) <= tol, name


@pytest.mark.parametrize("name", ["v3_2x2", "smollm_2x1", "mamba2_1x2",
                                  "smollm_1x2", "smollm_2x2", "danube_1x2",
                                  "whisper_1x2", "zamba2_1x2",
                                  "smollm_2x1_odd"])
def test_train_step_matches_reference(runs, name):
    """One ``make_train_step`` step on the reference's mesh, from its
    initial parameters and batch, each rank on its block of the batch
    (``step.block``: its rows of every micro-batch, its segment of the
    sequence): deepseek-v3-tiny on 2 x 2 (expert and data parallelism on
    the segments, ZeRO shards with the experts gathered lazily, the
    sharded OT loss, the MTP loss across the segments' boundary, two
    micro-batches), smollm-tiny on 2 x 1, 1 x 2 and 2 x 2 (attention's
    K / V gathered over "model"), mamba2-tiny on 1 x 2 (the SSD's context
    parallelism, the conv's halo), h2o-danube3-tiny on 1 x 2 at S = 128
    (its window of 64 reaches into the previous segment), whisper-tiny on
    1 x 2 (the encoder's length split too), zamba2-tiny on 1 x 2 (the
    shared block on segments), smollm-tiny on 2 x 1 with a batch of 3
    (replicated); every rank's gathered parameters are the same bits."""
    arch, mesh, _, _, _, part = W.TRAIN[name]
    want = _ref(runs, part)[name]
    ranks = [rank[name] for rank in _world(runs, mesh[0] * mesh[1])]
    _step_agrees(ranks[0], want, get_config(arch).zero3)
    for rank in ranks[1:]:
        for leaf, other in zip(rank["params"].values(),
                               ranks[0]["params"].values()):
            np.testing.assert_array_equal(leaf, other)
        assert rank["metrics"] == ranks[0]["metrics"]
    if name == "v3_2x2":
        assert ranks[0]["micro_batches"] == 2
        assert ranks[0]["m_dtype"] == "torch.bfloat16"


def test_an_indivisible_batch_replicates_as_the_one_card_step(runs):
    """smollm-tiny on 2 x 1 with a batch of 3 rows, which does not divide
    over the data axis: every rank runs all three rows, and the step
    equals the same step with no mesh at the step bars (both solving the
    OT loss in float32, as the sharded solve does)."""
    for rank in _world(runs, 2):
        got = rank["smollm_2x1_odd"]
        _step_agrees(got["f32"], got["one"], False)


def test_prefill_on_a_mesh_equals_one_rank(runs):
    """smollm-tiny's prefill on 1 x 2: each rank runs its segment of the
    sequence (8 of 16 positions), and the last position's logits, the
    last rank's, come back to both within 1e-5 of max |logit| of the
    prefill with no mesh."""
    for rank in _world(runs, 2):
        got = rank["prefill_smollm"]
        assert got["block"] == (2, 8)
        assert _rel_to_max(got["got"], got["want"]) <= DECODE_TOL


def test_moe_capacity_drops_on_a_1x1_mesh_match_reference(runs):
    """deepseek-v3-tiny on a 1 x 1 mesh runs the expert-parallel MoE with
    its capacities, as the reference's step always does: on a batch whose
    first rows repeat one token (every one of their tokens dispatched to
    the same experts) its step equals the reference's, and differs from
    the dense experts' step (no mesh) by more than the bars."""
    want = _ref(runs, "c")["v3_1x1"]
    got = _world(runs, 1)[0]["v3_1x1"]
    _step_agrees(got["mesh"], want, True)
    dense = got["dense"]
    assert abs(dense["metrics"]["ce"] - want["metrics"]["ce"]) > \
        1e-4 * abs(want["metrics"]["ce"])


def test_train_driver_on_its_default_1x1_mesh_matches_reference_driver(
        runs):
    """``launch.train --arch deepseek_v3_671b --tiny`` with its default
    ``--mesh 1x1`` and no world around it starts a world of one process,
    runs the MoE layers expert parallel with their capacities, as the
    reference's driver always does, and ends the world. From the
    reference driver's initial parameters, on a batch whose first rows
    repeat one token, both logged steps' metrics equal the reference
    driver's at the step bars, and the first differs from the dense
    experts' step (no mesh, nothing dropped) by more than them."""
    want = _ref(runs, "d")["driver"]
    got = _world(runs, 1)[0]["driver_1x1"]
    assert got["ended"]
    assert len(got["losses"]) == len(want) == 2
    for g, w in zip(got["losses"], want):
        for k in ("ce", "aux", "mtp", "loss"):
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
        assert g["ot"] == pytest.approx(w["ot"], rel=1e-4)
    dense = got["dense"]
    assert abs(dense["ce"] - want[0]["ce"]) > 1e-5 * abs(want[0]["ce"])
    assert abs(dense["ot"] - want[0]["ot"]) > 1e-4 * abs(want[0]["ot"])


@pytest.mark.parametrize("arch", W.EXACT_1X1)
def test_a_1x1_mesh_step_is_the_one_card_step_to_the_bit(runs, arch):
    """Three train steps of smollm-tiny and zamba2-tiny (the SSD and the
    shared block) on a 1 x 1 mesh, with the default AdamW, give the same
    bits as the steps with no mesh: the driver, which always runs on a
    mesh, resumes onto the mesh-less step exactly."""
    got = _world(runs, 1)[0]["exact_1x1"][arch]
    assert got["metrics"][0] == got["metrics"][1]
    assert got["same"]


@pytest.mark.parametrize("case,world", [("decode_smollm", 2),
                                        ("decode_v3", 4)])
def test_decode_on_a_mesh_equals_one_rank(runs, case, world):
    """Three decode steps of smollm-tiny on 2 x 1 and deepseek-v3-tiny on
    2 x 2 (each rank its batch rows of the caches, the parameters'
    shards gathered, the experts dense) equal the same steps on one
    process with no mesh."""
    for rank in _world(runs, world):
        got = rank[case]
        assert got["cache_rows"] == 2
        assert _rel_to_max(got["got"], got["want"]) <= DECODE_TOL


def test_train_driver_resumes_on_a_mesh(runs):
    """``launch.train --mesh 2x1 --device cpu``: each rank writes
    ``shard_<rank>.npz``, rank 0 the manifest and ``COMMIT``; with the
    last commit dropped, ``--resume`` restores step 1 and replays steps 2
    and 3 with the uninterrupted run's losses, on both ranks."""
    for rank in _world(runs, 2):
        got = rank["driver"]
        assert got["files"] == ["COMMIT", "manifest.json", "shard_0.npz",
                                "shard_1.npz"]
        assert got["start"] == 2
        assert got["again"][:2] == pytest.approx(got["first"][2:], rel=1e-6)
        assert all(np.isfinite(got["first"]))
