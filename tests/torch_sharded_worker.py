"""One rank of a gloo world for ``test_torch_sharded.py``.

    python tests/torch_sharded_worker.py RANK WORLD INIT_FILE OUT_FILE

joins a world of WORLD processes through ``init_method=file://INIT_FILE``
(a process-group timeout of 60 s, so a rank whose peer died raises rather
than block), builds a ``DeviceMesh("cpu", (WORLD,), ("data",))`` and runs
every case of :data:`CASES` and :data:`REFUSALS` on the same numpy inputs
(:func:`inputs`, from a seed), then writes ``{case: result}`` to OUT_FILE
with ``torch.save``. A rank that fails writes its traceback instead and
exits 1. The module imports torch and the port only, never JAX: the test
holds these results against the JAX package in its own process.
"""
from __future__ import annotations

import contextlib
import datetime
import sys
import traceback

import numpy as np
import torch

N, M, D, R = 91, 77, 2, 16          # n % p != 0 for p = 2, 3, 4
RADIUS = 2.0
ZERO_A = (3, 30, 50, 70, 88)         # zero weights on 4 of 4 shards
ZERO_B = (5, 40, 75)


def inputs() -> dict:
    """The cases' numpy inputs, the same in every process."""
    rng = np.random.default_rng(23)
    x = (0.5 * rng.standard_normal((N, D))).astype(np.float32)
    y = (0.5 * rng.standard_normal((M, D)) + 0.2).astype(np.float32)
    anchors = (0.7 * rng.standard_normal((R, D))).astype(np.float32)
    xi = np.exp(rng.standard_normal((N, 12))).astype(np.float32)
    zeta = np.exp(rng.standard_normal((M, 12))).astype(np.float32)
    log_xi = rng.standard_normal((N, 12)).astype(np.float32)
    log_zeta = rng.standard_normal((M, 12)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, N).astype(np.float32)
    b = rng.uniform(0.5, 1.5, M).astype(np.float32)
    a[list(ZERO_A)] = 0.0
    b[list(ZERO_B)] = 0.0
    return dict(x=x, y=y, anchors=anchors, xi=xi, zeta=zeta, log_xi=log_xi,
                log_zeta=log_zeta, a_zero=a / a.sum(), b_zero=b / b.sum())


def _t(v):
    return torch.as_tensor(v)


def _solve_out(res) -> dict:
    return dict(cost=float(res.cost), n_iter=int(res.n_iter),
                err=float(res.marginal_err), f=res.f.numpy().copy(),
                g=res.g.numpy().copy())


def _geoms(inp, eps=0.5):
    from repro_torch.core import (ArcCosinePointCloud, FactoredPositive,
                                  GaussianPointCloud)
    x, y, u = _t(inp["x"]), _t(inp["y"]), _t(inp["anchors"])
    return dict(
        factored=FactoredPositive(xi=_t(inp["xi"]), zeta=_t(inp["zeta"]),
                                  eps=eps),
        log_factored=FactoredPositive(log_xi=_t(inp["log_xi"]),
                                      log_zeta=_t(inp["log_zeta"]), eps=eps),
        gaussian=GaussianPointCloud.build(x, y, u, eps=eps, R=RADIUS),
        arccos=ArcCosinePointCloud(x, y, u, eps=eps))


def _problem(geom, a=None, b=None):
    from repro_torch.core import OTProblem
    return OTProblem.from_geometry(geom, a, b, device="cpu")


def _solve_case(family, method, eps=0.5, **kw):
    def case(mesh, inp):
        from repro_torch.core import solve
        return _solve_out(solve(_problem(_geoms(inp, eps)[family]),
                                method=method, mesh=mesh, **kw))
    return case


def _padding(mode):
    def case(mesh, inp):
        from repro_torch.core import sharded_sinkhorn_geometry
        family = "factored" if mode == "scaling" else "log_factored"
        return _solve_out(sharded_sinkhorn_geometry(
            mesh, _geoms(inp)[family], _t(inp["a_zero"]), _t(inp["b_zero"]),
            mode=mode, tol=1e-6))
    return case


def _warm(mesh, inp):
    """A cold solve to 1e-3, then a solve warm-started from it to 1e-6."""
    from repro_torch.core import sharded_sinkhorn_geometry
    g = _geoms(inp)["gaussian"]
    a, b = _problem(g).a, _problem(g).b
    cold = sharded_sinkhorn_geometry(mesh, g, a, b, mode="log", tol=1e-3)
    warm = sharded_sinkhorn_geometry(mesh, g, a, b, mode="log", tol=1e-6,
                                     f_init=cold.f, g_init=cold.g)
    return dict(_solve_out(warm), cold_f=cold.f.numpy().copy(),
                cold_g=cold.g.numpy().copy(), cold_iter=int(cold.n_iter))


def _fixed(mode):
    """A fixed 40 iterations (tol 0) of the sharded solver itself, as the
    JAX package's own sharded tests hold theirs."""
    def case(mesh, inp):
        from repro_torch.core import sharded_sinkhorn_geometry
        g = _geoms(inp)["gaussian" if mode == "log" else "factored"]
        p = _problem(g)
        return _solve_out(sharded_sinkhorn_geometry(
            mesh, g, p.a, p.b, mode=mode, tol=0.0, max_iter=40))
    return case


def _factored_fn(mesh, inp):
    from repro_torch.core import make_sharded_sinkhorn
    p = _problem(_geoms(inp)["factored"])
    fn = make_sharded_sinkhorn(mesh, eps=0.5, tol=1e-6)
    return _solve_out(fn(p.geometry.xi, p.geometry.zeta, p.a, p.b))


def _psum_lse(mesh, inp):
    """psum_logsumexp over the rows of (n, 3) values whose last column is
    all -inf, and its gradient: each rank passes its rows (padded rows
    -inf, as padded atoms' log-features add nothing) and differentiates
    its 1/p share of a loss every rank holds whole."""
    from repro_torch.distributed import MeshAxis, psum_logsumexp, shard_rows
    ax = MeshAxis(mesh, "data")
    full = torch.cat([_t(inp["log_xi"])[:, :2],
                      torch.full((N, 1), -torch.inf)], dim=1)
    full = torch.cat([full, torch.full((ax.padded(N) - N, 3), -torch.inf)])
    leaf = full.clone().requires_grad_(True)
    out = psum_logsumexp(shard_rows(leaf, ax), ax, dim=0)
    (grad,) = torch.autograd.grad(out[:2].sum() / ax.size, [leaf])
    return dict(value=out.detach().numpy().copy(),
                grad=grad.numpy().copy())


def _row_sharded_factored(mesh, inp):
    """A caller that holds its own rows: ``RowShardedFactored`` of this
    rank's padded factor rows through ``sinkhorn_geometry`` (padded atoms
    of zero weight and zero starting scaling), gathered."""
    from repro_torch.core import RowShardedFactored, sinkhorn_geometry
    from repro_torch.distributed import MeshAxis, shard_rows
    ax = MeshAxis(mesh)

    def rows(v, fill=None):
        v = _t(v)
        k = ax.padded(v.shape[0]) - v.shape[0]
        tail = v[-1:].expand(k, *v.shape[1:]) if fill is None else \
            torch.full((k,), fill)
        return shard_rows(torch.cat([v, tail]), ax)

    p = _problem(_geoms(inp)["factored"])
    g = RowShardedFactored(xi=rows(inp["xi"]), zeta=rows(inp["zeta"]),
                           eps=0.5, axis=ax)
    res = sinkhorn_geometry(g, rows(p.a.numpy(), 0.0), rows(p.b.numpy(), 0.0),
                            u_init=rows(np.ones(N, np.float32), 0.0),
                            tol=1e-6)
    return dict(_solve_out(res), f=ax.gather_rows(res.f)[:N].numpy(),
                g=ax.gather_rows(res.g)[:M].numpy())


def _auto(mesh, inp):
    """``solve(mesh=)`` with method "auto": the Gaussian problem takes the
    log plan, linear features the scaling plan."""
    from repro_torch.core import solve
    from repro_torch.kernels.ops import observe_plan_selection
    geoms = _geoms(inp)
    with observe_plan_selection() as events:
        res = solve(_problem(geoms["gaussian"]), mesh=mesh)
        lin = solve(_problem(geoms["factored"]), mesh=mesh)
    return dict(_solve_out(res), lin_cost=float(lin.cost),
                modes=[e["mode"] for e in events])


def _many(mesh, inp):
    from repro_torch.core import solve_many
    geoms = _geoms(inp)
    probs = [_problem(geoms["gaussian"]), _problem(geoms["log_factored"])]
    return dict(results=[_solve_out(r) for r in solve_many(
        probs, method="log_factored", mesh=mesh)])


def _spec(mesh, inp):
    from repro_torch.core import ExecutionPolicy, SolveSpec, solve
    spec = SolveSpec(geometry=_geoms(inp)["gaussian"],
                     policy=ExecutionPolicy(mesh=mesh, device="cpu"))
    return _solve_out(solve(spec))


def _annealed(mesh, inp):
    from repro_torch.core import EpsSchedule, solve_annealed
    out = solve_annealed(_problem(_geoms(inp, eps=0.1)["gaussian"]),
                         schedule=EpsSchedule(eps_init=1.0, decay=0.5),
                         tol=1e-5, mesh=mesh)
    return dict(_solve_out(out.result),
                stage_iters=[int(k) for k in out.stage_iters])


def _leaves(inp):
    return [_t(inp[k]).clone().requires_grad_(True)
            for k in ("x", "y", "anchors", "a_zero", "b_zero")]


def _divergence(mesh, inp):
    """The divergence and its gradients in the supports, the shared
    anchors and the weights (zero weights on several shards)."""
    from repro_torch.core import (GaussianPointCloud,
                                  sinkhorn_divergence_geometry)
    x, y, u, a, b = leaves = _leaves(inp)
    geom = GaussianPointCloud.build(x, y, u, eps=0.5, R=RADIUS)
    val = sinkhorn_divergence_geometry(geom, a, b, tol=1e-6, mesh=mesh)
    grads = torch.autograd.grad(val, leaves)
    return dict(value=float(val.detach()),
                grads=[gr.numpy().copy() for gr in grads])


def _objective(mesh, inp):
    from repro_torch.core import ExecutionPolicy, OTObjective
    x, y, u = leaves = _leaves(inp)[:3]
    obj = OTObjective(eps=0.5, tol=1e-6, max_iter=2000,
                      policy=ExecutionPolicy(mesh=mesh, device="cpu"))
    val = obj(obj.gaussian(x, y, u, R=RADIUS))
    grads = torch.autograd.grad(val, leaves)
    return dict(value=float(val.detach()),
                grads=[gr.numpy().copy() for gr in grads])


# case -> fn(mesh, inputs) -> dict of numbers and numpy arrays
CASES = {
    "factored_scaling": _solve_case("factored", "sharded", tol=1e-6),
    "factored_log": _solve_case("log_factored", "sharded_log", tol=1e-6),
    "gaussian_log": _solve_case("gaussian", "sharded_log", tol=1e-6),
    "gaussian_log_plain": _solve_case("gaussian", "sharded_log", tol=1e-6,
                                      use_pallas=False),
    "gaussian_scaling": _solve_case("gaussian", "sharded", tol=1e-6),
    "gaussian_small_eps": _solve_case("gaussian", "sharded_log", eps=0.01,
                                      tol=0.0, max_iter=100),
    "arccos_log": _solve_case("arccos", "sharded_log", tol=1e-6),
    "arccos_scaling": _solve_case("arccos", "sharded", tol=1e-6),
    "factored_fn": _factored_fn,
    "row_sharded_factored": _row_sharded_factored,
    "fixed_log": _fixed("log"),
    "fixed_scaling": _fixed("scaling"),
    "psum_lse": _psum_lse,
    "momentum": _solve_case("log_factored", "sharded_log", tol=1e-5,
                            momentum=1.3),
    "padding_scaling": _padding("scaling"),
    "padding_log": _padding("log"),
    "warm": _warm,
    "auto": _auto,
    "solve_many": _many,
    "spec": _spec,
    "annealed": _annealed,
    "divergence": _divergence,
    "objective": _objective,
}


def _refusal(fn):
    def case(mesh, inp):
        try:
            fn(mesh, inp)
        except Exception as exc:            # the refusal is the result
            return dict(type=type(exc).__name__, message=str(exc))
        return dict(type=None, message="")
    return case


def _no_log_family(mesh, inp):
    from repro_torch.core import FactoredPositive, sharded_sinkhorn_geometry

    class NoLog(FactoredPositive):
        supports_log = False

    g = NoLog(xi=_t(inp["xi"]), zeta=_t(inp["zeta"]), eps=0.5)
    p = _problem(g)
    sharded_sinkhorn_geometry(mesh, g, p.a, p.b, mode="log")


def _unshardable(family):
    def fn(mesh, inp):
        from repro_torch.core import (DenseCost, GridSeparable,
                                      NystromLowRank,
                                      sharded_sinkhorn_geometry)
        x, y = _t(inp["x"]), _t(inp["y"])
        g = {"nystrom": lambda: NystromLowRank.from_landmarks(
                 x, y, x[:8], eps=0.5),
             "dense": lambda: DenseCost(torch.cdist(x, y) ** 2, 0.5),
             "grid": lambda: GridSeparable.build(
                 [torch.linspace(0, 1, 6)] * 2, eps=0.5, device="cpu")}[
            family]()
        p = _problem(g)
        sharded_sinkhorn_geometry(mesh, g, p.a, p.b, mode="scaling")
    return fn


def _solve_with(**kw):
    def fn(mesh, inp):
        from repro_torch.core import solve
        solve(_problem(_geoms(inp)["gaussian"]), **{"mesh": mesh, **kw})
    return fn


def _many_with(method):
    def fn(mesh, inp):
        from repro_torch.core import solve_many
        solve_many([_problem(_geoms(inp)["gaussian"])], method=method,
                   mesh=mesh)
    return fn


def _bad_mode(mesh, inp):
    from repro_torch.core import sharded_sinkhorn_geometry
    p = _problem(_geoms(inp)["gaussian"])
    sharded_sinkhorn_geometry(mesh, p.geometry, p.a, p.b, mode="bogus")


def _production_mesh():
    from repro_torch.launch.mesh import make_production_mesh
    make_production_mesh(device="cpu")


# refusal -> the call that must raise; the result is (type, message)
REFUSALS = {name: _refusal(fn) for name, fn in {
    "inner_steps": _solve_with(method="sharded_log", inner_steps=8),
    "mode": _bad_mode,
    "axis": _solve_with(mesh_axis="pod"),
    "no_log_family": _no_log_family,
    "nystrom": _unshardable("nystrom"),
    "dense": _unshardable("dense"),
    "grid": _unshardable("grid"),
    "local_method": _solve_with(method="quadratic"),
    "many_method": _many_with("nystrom"),
    "no_mesh": lambda mesh, inp: _solve_with(method="sharded")(None, inp),
    "production_mesh": lambda mesh, inp: _production_mesh(),
}.items()}


@contextlib.contextmanager
def world_of_one(init_file):
    """This process alone as a gloo world (``file://init_file``, a 60 s
    timeout) and its ``DeviceMesh("cpu", (1,), ("data",))``; the group is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    rank, world, init_file, out_file = (int(argv[0]), int(argv[1]), argv[2],
                                        argv[3])
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(world, device="cpu")
        inp = inputs()
        out = {name: fn(mesh, inp) for name, fn in CASES.items()}
        out.update({f"refuse:{name}": fn(mesh, inp)
                    for name, fn in REFUSALS.items()})
        torch.save(out, out_file)
        dist.destroy_process_group()
    except Exception:
        with open(out_file + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
