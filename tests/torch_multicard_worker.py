"""One rank of a gloo world for ``test_torch_multicard.py``, and the inputs
both packages take.

    python tests/torch_multicard_worker.py RANK WORLD INIT_FILE OUT_FILE REF_DIR

joins a world of WORLD processes through ``init_method=file://INIT_FILE``
(a 60 s process-group timeout, one torch thread), runs every case of its
world on the CPU and ``torch.save``s ``{case: result}`` to OUT_FILE (a
failure's traceback goes to ``OUT_FILE.err``). The train-step cases wait
for the JAX package's initial parameters, which the reference process
(``torch_multicard_reference.py``) pickles into REF_DIR before it
compiles anything. The inputs below are numpy, made from seeds, and the
same for the port and the reference. Importing this module imports
numpy only.
"""
import datetime
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np

F32 = dict(param_dtype="float32", compute_dtype="float32")
ADAMW = dict(lr=1.0, eps=1.0)   # the first update ~ linear in the gradient
TOTAL_STEPS = 50
PARAMS_WAIT_S = 240

EP = dict(T=32, d=16, f=32, E=8, k=2, capacity_factor=1.25)
EP_ROUTERS = ("softmax", "sinkhorn")
SSD = dict(B=2, S=64, H=2, P=4, N=3, chunk=8)
COMPRESS_COLS = 512
TINY_V3 = dict(d_model=64, n_experts=8, vocab=256, ot_iters=5)

# name -> (arch, (data, model), batch, seq, tiny overrides, reference part)
TRAIN = {
    "v3_2x2": ("deepseek_v3_671b", (2, 2), 4, 32, TINY_V3, "a"),
    "v3_1x1": ("deepseek_v3_671b", (1, 1), 4, 32, TINY_V3, "c"),
    "smollm_2x1": ("smollm-135m", (2, 1), 4, 16, dict(ot_iters=6), "b"),
    "mamba2_1x2": ("mamba2_1p3b", (1, 2), 2, 32, dict(ot_iters=5), "c"),
    # the sequence over "model": attention's K / V gathers, positions
    "smollm_1x2": ("smollm-135m", (1, 2), 2, 16, dict(ot_iters=6), "d"),
    "smollm_2x2": ("smollm-135m", (2, 2), 4, 16, dict(ot_iters=6), "a"),
    # the tiny window of 64 crosses the segments' boundary at S = 128
    "danube_1x2": ("h2o_danube3_4b", (1, 2), 2, 128, dict(ot_iters=5),
                   "c"),
    # the encoder's length split too: its K / V and cross-attention's
    "whisper_1x2": ("whisper_base", (1, 2), 2, 16, dict(ot_iters=5), "d"),
    # the SSD's context parallelism, the conv's halo and the shared block
    "zamba2_1x2": ("zamba2_1p2b", (1, 2), 2, 32, dict(ot_iters=5), "b"),
    # a batch of 3 rows does not divide over 2 data ranks: replicated
    "smollm_2x1_odd": ("smollm-135m", (2, 1), 3, 16, dict(ot_iters=6),
                       "c"),
}
# ``launch.train`` on deepseek-v3-tiny with its default 1x1 mesh, on
# ``drop_batch``: the reference's driver (part c) and the port's, the
# latter run before the world-of-1 worker joins its world
DRIVER_BATCH, DRIVER_SEQ = 4, 32
DRIVER_ARGV = ["--arch", "deepseek_v3_671b", "--tiny", "--batch",
               str(DRIVER_BATCH), "--seq", str(DRIVER_SEQ), "--steps", "2",
               "--log-every", "1"]
DRIVER_LR = 3e-4                # the driver's default --lr
BEFORE_WORLD = {1: ("driver_1x1",)}
# steps on a 1 x 1 mesh and with no mesh, to the bit
EXACT_1X1 = ("smollm-135m", "zamba2_1p2b")
WORLDS = {1: ("ep", "v3_1x1", "exact_1x1"),
          2: ("compress", "ep", "ssd", "smollm_2x1", "mamba2_1x2",
              "smollm_1x2", "danube_1x2", "whisper_1x2", "zamba2_1x2",
              "smollm_2x1_odd", "prefill_smollm", "decode_smollm",
              "driver"),
          4: ("compress", "ep", "ssd", "v3_2x2", "smollm_2x2",
              "decode_v3")}


def ep_inputs(world: int):
    """The MoE layer's parameters, the tokens of every rank (world * T,
    d) and the output's cotangent. The tokens share one large component
    that the router maps to a few experts, so at capacity factor 1.25
    assignments overflow and are dropped."""
    rng = np.random.default_rng(10 + world)
    d, f, E = EP["d"], EP["f"], EP["E"]
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.5,
         "up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
         "gate": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
         "down": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2}
    common = rng.standard_normal(d).astype(np.float32)
    x = (rng.standard_normal((world * EP["T"], d)).astype(np.float32) * 0.5
         + 1.5 * common)
    cot = rng.standard_normal((world * EP["T"], d)).astype(np.float32)
    return p, x, cot


def ssd_inputs():
    rng = np.random.default_rng(3)
    B, S, H, P, N = (SSD[k] for k in "BSHPN")
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, cot


def compress_inputs(world: int):
    rng = np.random.default_rng(20 + world)
    return (rng.standard_normal((world, COMPRESS_COLS)) * 0.1).astype(
        np.float32)


def train_batch(name: str, vocab: int, enc_d_model: int = 0):
    """Tokens and labels (B, S) of a train case; the 1 x 1 case's is
    :func:`drop_batch`. With ``enc_d_model`` (an encoder-decoder config)
    also ``enc_embeds`` (B, S, enc_d_model) from seed 8."""
    _, _, B, S, _, _ = TRAIN[name]
    out = drop_batch(B, S, vocab, drops=name == "v3_1x1")
    if enc_d_model:
        out["enc_embeds"] = np.random.default_rng(8).standard_normal(
            (B, S, enc_d_model)).astype(np.float32)
    return out


def drop_batch(B: int, S: int, vocab: int, drops: bool = True):
    """Tokens and labels (B, S) from seed 5; with ``drops`` the first two
    rows repeat one token, so their MoE inputs are equal rows that all
    pick the same experts and overflow the capacity."""
    rng = np.random.default_rng(5)
    tok = rng.integers(0, vocab, (B, S + 1))
    if drops:
        tok[:2] = 7
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def params_file(ref_dir, name: str) -> Path:
    return Path(ref_dir) / f"params_{name}.pkl"


def wait_params(ref_dir, name: str):
    path = params_file(ref_dir, name)
    deadline = time.monotonic() + PARAMS_WAIT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path.name} from the reference")
        time.sleep(0.1)
    with open(path, "rb") as fh:
        return pickle.load(fh)


# ---------------------------------------------------------------------------
# The port's side (imports torch and repro_torch only inside)
# ---------------------------------------------------------------------------


def _np_tree(tree):
    from repro_torch.tree import named_leaves
    return {n: t.detach().float().numpy().copy()
            for n, t in named_leaves(tree)}


def _compress(world, ref_dir):
    import torch
    from repro_torch.distributed import MeshAxis
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import compressed_psum
    x = compress_inputs(world)
    axis = MeshAxis(make_local_mesh(world, device="cpu"), "data")
    return compressed_psum(torch.tensor(x[axis.rank:axis.rank + 1]),
                           axis).numpy()


def _ep_one(world, router):
    import torch
    from repro_torch.distributed import MeshAxis
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import moe_ep_local
    p, x, cot = ep_inputs(world)
    axis = MeshAxis(make_local_mesh(1, world, device="cpu"), "model")
    r, T, e = axis.rank, EP["T"], EP["E"] // world
    p_loc = {"router": torch.tensor(p["router"])}
    p_loc.update({k: torch.tensor(p[k][r * e:(r + 1) * e])
                  for k in ("up", "gate", "down")})
    leaves = [t.requires_grad_(True) for t in p_loc.values()]
    x_loc = torch.tensor(x[r * T:(r + 1) * T]).requires_grad_(True)
    stats = {}
    out, aux = moe_ep_local(p_loc, x_loc, top_k=EP["k"], n_experts=EP["E"],
                            axis=axis, router=router,
                            capacity_factor=EP["capacity_factor"],
                            stats=stats)
    loss = torch.sum(out * torch.tensor(cot[r * T:(r + 1) * T]))
    grads = torch.autograd.grad(loss, leaves + [x_loc])
    return dict(out=out.detach().numpy(), aux=float(aux),
                kept=stats["kept"].numpy(),
                grads={k: g.numpy() for k, g in
                       zip(list(p_loc) + ["x"], grads)})


def _ep(world, ref_dir):
    return {router: _ep_one(world, router) for router in EP_ROUTERS}


def _ssd(world, ref_dir):
    """The SSD on the rank's segment of the sequence, its output gathered
    back whole (the gather's backward sums the ranks' cotangents, each
    rank holding the whole loss)."""
    import torch
    from repro_torch.distributed import MeshContext, all_gather, \
        use_mesh_context
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.ssm import ssd_context_parallel
    x, dt, A, Bm, Cm, cot = (torch.tensor(a) for a in ssd_inputs())
    x.requires_grad_(True)
    ctx = MeshContext(make_local_mesh(1, world, device="cpu"))
    tp = ctx.axis("model")
    seg = x.shape[1] // world
    x_l, dt_l, B_l, C_l = (t[:, tp.rank * seg:(tp.rank + 1) * seg]
                           for t in (x, dt, Bm, Cm))
    with use_mesh_context(ctx):
        y = all_gather(ssd_context_parallel(x_l, dt_l, A, B_l, C_l,
                                            chunk=SSD["chunk"]), tp, dim=1)
    (gx,) = torch.autograd.grad(torch.sum(y * cot), [x])
    return dict(y=y.detach().numpy(), gx=gx.numpy())


def _config(name, **extra):
    from repro_torch.configs import get_config
    arch, _, _, _, kw, _ = TRAIN[name]
    return get_config(arch).tiny(**F32, **kw, **extra)


def _train(name, ref_dir, mesh=True, **extra):
    """One step of the case on its mesh (or, ``mesh=False``, on one
    process with no mesh), its config with ``extra`` overrides: the
    metrics, the gathered parameters and first moments, and the
    micro-batches the step ran."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, init_adamw
    _, (D, M), B, S, _, _ = TRAIN[name]
    cfg = _config(name, **extra)
    params = convert.lm_params(wait_params(ref_dir, name), cfg, device="cpu")
    batch = {k: torch.tensor(v) for k, v in train_batch(
        name, cfg.vocab, cfg.d_model if cfg.input_kind == "encdec" else 0
    ).items()}
    step, _ = make_train_step(
        cfg, make_local_mesh(D, M, device="cpu") if mesh else None,
        ShapeSpec("t", S, B, "train"), AdamWConfig(**ADAMW),
        total_steps=TOTAL_STEPS)
    if mesh:
        specs, ctx = step.shardings[0], step.context
        params = shard_tree(params, specs, ctx)
    new, state, metrics = step(params, init_adamw(params, step.opt),
                               step.block(batch))
    if mesh:
        new, m = gather_tree(new, specs, ctx), gather_tree(state.m, specs,
                                                           ctx)
    else:
        m = state.m
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params=_np_tree(new), m=_np_tree(m),
                micro_batches=step.micro_batches,
                m_dtype=str(next(iter(_leaves(state.m))).dtype))


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _train_1x1(name, ref_dir):
    return dict(mesh=_train(name, ref_dir),
                dense=_train(name, ref_dir, mesh=False))


def _driver_1x1(world, ref_dir):
    """``launch.train`` (``DRIVER_ARGV``, ``--device cpu``) with no world
    around it, from the reference driver's initial parameters and on
    ``drop_batch`` at every step: the logged metrics, whether the driver
    ended the world of one process it started, and the metrics of one
    step of the same model with no mesh (the experts dense)."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, init_adamw
    cfg = get_config("deepseek_v3_671b").tiny(**F32)
    ref = wait_params(ref_dir, "driver")
    batch = {k: torch.tensor(v) for k, v in
             drop_batch(DRIVER_BATCH, DRIVER_SEQ, cfg.vocab).items()}
    init, batch_at = train.init_params, train.DataPipeline.batch_at
    train.init_params = lambda cfg_, device, generator: convert.lm_params(
        ref, cfg_, device=device)
    train.DataPipeline.batch_at = lambda self, step: batch
    try:
        got = train.main(DRIVER_ARGV + ["--device", "cpu"])
    finally:
        train.init_params, train.DataPipeline.batch_at = init, batch_at
    ended = not dist.is_initialized()
    params = convert.lm_params(ref, cfg, device="cpu")
    step, _ = make_train_step(cfg, None, ShapeSpec(
        "t", DRIVER_SEQ, DRIVER_BATCH, "train"), AdamWConfig(lr=DRIVER_LR),
        total_steps=2)
    _, _, dense = step(params, init_adamw(params, step.opt), batch)
    return dict(losses=got["losses"], ended=ended,
                dense={k: float(v) for k, v in dense.items()})


def _exact_1x1(world, ref_dir):
    """Three steps of each ``EXACT_1X1`` config (tiny, float32, the
    default AdamW) on a 1 x 1 mesh and with no mesh, from the same
    weights and batch: whether the parameters and optimizer state are
    the same bits, and both runs' last metrics."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.tree import tree_leaves
    out = {}
    for arch in EXACT_1X1:
        cfg = get_config(arch).tiny(**F32)
        batch = {k: torch.tensor(v) for k, v in
                 drop_batch(2, 16, cfg.vocab, drops=False).items()}
        runs = []
        for mesh in (make_local_mesh(1, 1, device="cpu"), None):
            step, _ = make_train_step(cfg, mesh, ShapeSpec("t", 16, 2,
                                                           "train"),
                                      AdamWConfig(), total_steps=6)
            params = init_params(cfg, device="cpu", seed=3)
            if mesh is not None:
                params = shard_tree(params, step.shardings[0], step.context)
            state = (params, init_adamw(params, step.opt))
            for _ in range(3):
                *state, metrics = step(state[0], state[1],
                                       step.block(batch))
            runs.append((tree_leaves(state),
                         {k: float(v) for k, v in metrics.items()}))
        (a, ma), (b, mb) = runs
        out[arch] = dict(same=len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b)), metrics=(ma, mb))
    return out


def _decode(arch, kw, mesh_shape, B=4, S=16, steps=3):
    """Decode steps on the mesh (the rank's shards and batch rows)
    against the same steps with no mesh on this process."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import shard_tree
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_caches, init_params, shard_caches
    cfg = get_config(arch).tiny(**F32, **kw)
    params = init_params(cfg, device="cpu", seed=1)
    shape = ShapeSpec("d", S, B, "decode")
    tok = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                         (B, steps)))
    one, _ = make_serve_step(cfg, None, shape)
    step, _ = make_serve_step(cfg, make_local_mesh(*mesh_shape,
                                                   device="cpu"), shape)
    shards = shard_tree(params, step.shardings[0], step.context)
    c_one = init_caches(cfg, B, S, device="cpu")
    c_mesh = shard_caches(cfg, init_caches(cfg, B, S, device="cpu"),
                          step.context)
    got, want = [], []
    for t in range(steps):
        lw, c_one = one(params, {"tokens": tok[:, t:t + 1]}, c_one)
        lg, c_mesh = step(shards, step.block({"tokens": tok[:, t:t + 1]}),
                          c_mesh)
        want.append(lw.numpy())
        got.append(lg.numpy())
    return dict(got=np.stack(got), want=np.stack(want),
                cache_rows=int(c_mesh[0][0].shape[1]))


def _prefill(arch, kw, mesh_shape, B=2, S=16):
    """A prefill on the mesh (the rank's shards, its rows and segment of
    the sequence) against the same prefill with no mesh on this
    process."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import shard_tree
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_params
    cfg = get_config(arch).tiny(**F32, **kw)
    params = init_params(cfg, device="cpu", seed=2)
    shape = ShapeSpec("p", S, B, "prefill")
    batch = {"tokens": torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, S)))}
    one, _ = make_serve_step(cfg, None, shape)
    step, _ = make_serve_step(cfg, make_local_mesh(*mesh_shape,
                                                   device="cpu"), shape)
    shards = shard_tree(params, step.shardings[0], step.context)
    block = step.block(batch)
    return dict(got=step(shards, block).numpy(),
                want=one(params, batch).numpy(),
                block=tuple(block["tokens"].shape))


def _driver(world, ref_dir):
    """``launch.train --mesh 2x1 --device cpu`` with checkpoints: four
    steps saving after steps 1 and 3; the last commit dropped, then
    ``--resume`` (the same four-step schedule) restores step 1 and replays
    steps 2 and 3 against the uninterrupted run's."""
    import torch.distributed as dist
    from repro_torch.launch import train
    ck = Path(ref_dir) / "driver_ck"
    base = ["--arch", "smollm-135m", "--tiny", "--device", "cpu", "--mesh",
            "2x1", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--save-every", "2", "--steps", "4", "--ckpt-dir", str(ck)]
    first = train.main(base)
    files = sorted(p.name for p in (ck / "step_000000003").iterdir())
    dist.barrier()
    if dist.get_rank() == 0:
        (ck / "step_000000003" / "COMMIT").unlink()
    dist.barrier()
    again = train.main(base + ["--resume"])
    return dict(first=[m["loss"] for m in first["losses"]],
                again=[m["loss"] for m in again["losses"]],
                start=again["start"], files=files)


CASES = {
    "compress": _compress,
    "ep": _ep,
    "ssd": _ssd,
    "v3_1x1": lambda w, d: _train_1x1("v3_1x1", d),
    "v3_2x2": lambda w, d: _train("v3_2x2", d),
    "smollm_2x1": lambda w, d: _train("smollm_2x1", d),
    "mamba2_1x2": lambda w, d: _train("mamba2_1x2", d),
    "smollm_1x2": lambda w, d: _train("smollm_1x2", d),
    "smollm_2x2": lambda w, d: _train("smollm_2x2", d),
    "danube_1x2": lambda w, d: _train("danube_1x2", d),
    "whisper_1x2": lambda w, d: _train("whisper_1x2", d),
    "zamba2_1x2": lambda w, d: _train("zamba2_1x2", d),
    # against one process, both sides solve the OT loss in float32, as
    # the sharded solve does whatever the storage policy
    "smollm_2x1_odd": lambda w, d: dict(
        _train("smollm_2x1_odd", d),
        f32=_train("smollm_2x1_odd", d, ot_precision="highest"),
        one=_train("smollm_2x1_odd", d, mesh=False,
                   ot_precision="highest")),
    "prefill_smollm": lambda w, d: _prefill("smollm-135m", {}, (1, 2)),
    "decode_smollm": lambda w, d: _decode("smollm-135m", {}, (2, 1)),
    "decode_v3": lambda w, d: _decode("deepseek_v3_671b", TINY_V3, (2, 2)),
    "driver": _driver,
    "driver_1x1": _driver_1x1,
    "exact_1x1": _exact_1x1,
}


def main(argv) -> int:
    rank, world, init_file, out_file, ref_dir = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        out = {}
        for name in BEFORE_WORLD.get(world, ()):
            t0 = time.perf_counter()
            out[name] = CASES[name](world, ref_dir)
            out[f"{name}:seconds"] = time.perf_counter() - t0
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        for name in WORLDS[world]:
            t0 = time.perf_counter()
            out[name] = CASES[name](world, ref_dir)
            out[f"{name}:seconds"] = time.perf_counter() - t0
        torch.save(out, out_file)
        dist.destroy_process_group()
    except Exception:
        with open(out_file + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
