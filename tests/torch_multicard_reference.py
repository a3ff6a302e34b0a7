"""The JAX package's multi-device results for ``test_torch_multicard.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_multicard_reference.py PART OUT_DIR

Four parts run side by side, each with the train steps of its
``W.TRAIN`` cases: ``a`` deepseek-v3-tiny's ``make_train_step`` on its
2 x 2 mesh, smollm-tiny's on 2 x 2; ``b`` the parameter, input and cache
shardings of every config on 1 x 1, 2 x 2 and 4 x 2 meshes,
``compressed_psum``, the expert-parallel MoE and the SSD's context
parallelism under ``shard_map``, smollm-tiny's step on 2 x 1 and
zamba2-tiny's on 1 x 2; ``c`` the steps of mamba2-tiny (1 x 2),
deepseek-v3-tiny (1 x 1), h2o-danube3-tiny (1 x 2) and smollm-tiny on
2 x 1 with a batch of 3; ``d`` the reference's ``launch.train`` on
deepseek-v3-tiny (1 x 1), and smollm-tiny's and whisper-tiny's steps on
1 x 2. Each part
first pickles the initial parameters of its train steps into OUT_DIR (the
port's ranks wait for them), then ``ref_<part>.pkl``. The inputs are those of
``torch_multicard_worker``.
"""
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_multicard_worker as W  # noqa: E402

from repro.configs import get_config, list_archs  # noqa: E402
from repro.configs.shapes import ShapeSpec  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    MeshContext,
    shard_map,
    use_mesh_context,
)
from repro.launch import specs as JS  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import abstract_state, make_train_step  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models.moe import moe_ep_local, router_probs  # noqa: E402
from repro.models.ssm import ssd_chunked, ssd_context_parallel  # noqa: E402
from repro.optim import AdamWConfig, compressed_psum, init_adamw  # noqa: E402

SPEC_MESHES = ((1, 1), (2, 2), (4, 2))
SPEC_SHAPE = (256, 8)            # seq, batch of the input and cache specs


def _name(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def named(tree):
    return {_name(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def specs():
    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        p_shape, _ = abstract_state(cfg)
        shapes = {_name(p): len(leaf.shape) for p, leaf in
                  jax.tree_util.tree_flatten_with_path(p_shape)[0]}
        S, B = SPEC_SHAPE
        for D, M in SPEC_MESHES:
            mesh = make_local_mesh(D, M)
            ps = JS.param_shardings(mesh, cfg, p_shape)
            params = {_name(p): _padded(s.spec, shapes[_name(p)]) for p, s in
                      jax.tree_util.tree_flatten_with_path(ps)[0]}
            inputs = {}
            for mode in ("train", "prefill", "decode"):
                sh = ShapeSpec("x", S, B, mode)
                ins = JS.input_specs(cfg, sh)
                dims = {_name(p): len(leaf.shape) for p, leaf in
                        jax.tree_util.tree_flatten_with_path(ins)[0]}
                got = JS.input_shardings(mesh, cfg, sh, ins)
                inputs[mode] = {
                    _name(p): _padded(s.spec, dims[_name(p)]) for p, s in
                    jax.tree_util.tree_flatten_with_path(got)[0]}
            dec = ShapeSpec("d", S, B, "decode")
            c_leaves = jax.tree.leaves(JS.cache_specs(cfg, dec))
            c_sh = jax.tree.leaves(JS.cache_shardings(mesh, cfg, dec))
            caches = [(tuple(c.shape), _padded(s.spec, len(c.shape)))
                      for c, s in zip(c_leaves, c_sh)]
            out[(arch, D, M)] = dict(params=params, inputs=inputs,
                                     caches=caches)
    return out


def compress():
    out = {}
    for world in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        fn = shard_map(lambda v: compressed_psum(v, "data"), mesh=mesh,
                       in_specs=P("data", None), out_specs=P("data", None),
                       check_vma=False)
        out[world] = np.asarray(jax.jit(fn)(W.compress_inputs(world)))
    return out


def ep():
    out = {}
    k, E, T = W.EP["k"], W.EP["E"], W.EP["T"]
    for world in (1, 2, 4):
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                    ("data", "model"))
        p, x, cot = W.ep_inputs(world)
        for router in W.EP_ROUTERS:
            fn = shard_map(
                lambda p_, x_: moe_ep_local(
                    p_, x_, top_k=k, n_experts=E, axis="model",
                    router=router,
                    capacity_factor=W.EP["capacity_factor"]),
                mesh=mesh,
                in_specs=({"router": P(None, None),
                           "up": P("model", None, None),
                           "gate": P("model", None, None),
                           "down": P("model", None, None)},
                          P("model", None)),
                out_specs=(P("model", None), P()), check_vma=False)

            def loss(p_, x_, fn=fn):
                y, aux = fn(p_, x_)
                return jnp.sum(y * cot), (y, aux)

            (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
            # each rank's dispatch, in moe_ep_local's order, for a recount
            idx = np.stack([np.asarray(jax.lax.top_k(router_probs(
                p, x[r * T:(r + 1) * T], top_k=k, router=router)[0], k)[1])
                for r in range(world)])
            out[(world, router)] = dict(
                out=np.asarray(y), aux=float(aux), idx=idx,
                grads=dict(named(grads[0]), x=np.asarray(grads[1])))
    return out


def ssd():
    x, dt, A, Bm, Cm, _ = W.ssd_inputs()
    chunk = W.SSD["chunk"]
    out = {"chunked": np.asarray(jax.jit(
        lambda *a: ssd_chunked(*a, chunk=chunk)[0])(x, dt, A, Bm, Cm))}
    for world in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                    ("data", "model"))
        with mesh, use_mesh_context(MeshContext(mesh)):
            out[world] = np.asarray(jax.jit(
                lambda *a: ssd_context_parallel(*a, chunk=chunk))(
                    x, dt, A, Bm, Cm))
    return out


def train_params(names):
    """Each case's config and initial parameters, pickled for the port's
    ranks before anything compiles."""
    made = {}
    for name in names:
        arch, _, _, _, kw, _ = W.TRAIN[name]
        cfg = get_config(arch).tiny(**W.F32, **kw)
        params = init_params(jax.random.PRNGKey(0), cfg)
        p_np = jax.tree.map(np.asarray, params)
        path = W.params_file(OUT, name)
        with open(str(path) + ".tmp", "wb") as fh:
            pickle.dump(p_np, fh)
        Path(str(path) + ".tmp").rename(path)
        made[name] = (cfg, params)
    return made


def train(name, cfg, params):
    _, (D, M), B, S, _, _ = W.TRAIN[name]
    mesh = make_local_mesh(D, M)
    opt = AdamWConfig(**W.ADAMW)
    step, _, _ = make_train_step(cfg, mesh, ShapeSpec("t", S, B, "train"),
                                 opt, total_steps=W.TOTAL_STEPS)
    batch = {k: jnp.asarray(v, jnp.float32 if k == "enc_embeds"
                            else jnp.int32)
             for k, v in W.train_batch(
                 name, cfg.vocab,
                 cfg.d_model if cfg.input_kind == "encdec" else 0).items()}
    with mesh:
        new, state, metrics = step(params, init_adamw(params, opt), batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params=named(new), m=named(state.m))


def driver():
    """The reference's own ``launch.train`` (``W.DRIVER_ARGV``, its
    default 1x1 mesh) on ``W.drop_batch`` at every step: each step's
    metrics. Its initial parameters are pickled for the port as it draws
    them, before anything compiles."""
    import repro.launch.train as RT
    metrics = []
    init, make, pipe = RT.init_params, RT.make_train_step, RT.DataPipeline

    def init_params_(key, cfg):
        params = init(key, cfg)
        path = W.params_file(OUT, "driver")
        with open(str(path) + ".tmp", "wb") as fh:
            pickle.dump(jax.tree.map(np.asarray, params), fh)
        Path(str(path) + ".tmp").rename(path)
        return params

    def make_train_step_(*args, **kw):
        step, *rest = make(*args, **kw)

        def recorded(params, opt_state, batch):
            out = step(params, opt_state, batch)
            metrics.append({k: float(v) for k, v in out[2].items()})
            return out
        return (recorded, *rest)

    class Drops(pipe):
        def batch_at(self, step):
            return {k: jnp.asarray(v, jnp.int32) for k, v in W.drop_batch(
                W.DRIVER_BATCH, W.DRIVER_SEQ, self.cfg.vocab).items()}

    argv = sys.argv
    RT.init_params, RT.make_train_step, RT.DataPipeline = (
        init_params_, make_train_step_, Drops)
    sys.argv = ["train"] + W.DRIVER_ARGV
    try:
        RT.main()
    finally:
        RT.init_params, RT.make_train_step, RT.DataPipeline = init, make, pipe
        sys.argv = argv
    return metrics


def main(part):
    names = [n for n, spec in W.TRAIN.items() if spec[5] == part]
    made = train_params(names)
    out = {}
    if part == "b":
        out.update(specs=specs(), compress=compress(), ep=ep(), ssd=ssd())
    if part == "d":
        out.update(driver=driver())
    for name in names:
        out[name] = train(name, *made[name])
    with open(OUT / f"ref_{part}.pkl.tmp", "wb") as fh:
        pickle.dump(out, fh)
    (OUT / f"ref_{part}.pkl.tmp").rename(OUT / f"ref_{part}.pkl")


if __name__ == "__main__":
    OUT = Path(sys.argv[2])
    main(sys.argv[1])
