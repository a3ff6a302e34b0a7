"""repro_torch's sharded solves over torch.distributed, against the JAX
package, on the CPU.

One module-scoped fixture starts gloo worlds of p = 1, 2, 3 and 4
processes together (``tests/torch_sharded_worker.py``: each rank joins
through a ``file://`` init method with a 60 s process-group timeout and
runs every case on a ``DeviceMesh("cpu", (p,), ("data",))``), and a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
that runs the JAX package's own sharded solver on 4 virtual devices.
While they run, this process computes the JAX package's single-device
results on the same numpy inputs. Each test then asserts one case of one
world, so each still counts; a world whose rank fails is killed at once
and fails its tests, and every wait has a deadline. n = 91, m = 77 leave
n % p != 0 for p = 2, 3, 4 (padded atoms). The bar is the port's:
cost rtol 1e-5, potentials atol 1e-5 on live atoms and -inf on dead
ones, n_iter equal (|d| <= 1 on the point-cloud feature plans, Gaussian
and arc-cosine, as the port's other tests hold them), gradients rtol 1e-4,
atol 1e-7; every rank's result is the same, bit for bit.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    ArcCosinePointCloud as JArcCos,
    EpsSchedule as JSchedule,
    FactoredPositive as JFactored,
    GaussianPointCloud as JGaussian,
    OTProblem as JProblem,
    sinkhorn_divergence_geometry as j_div,
    sinkhorn_geometry as j_scaling,
    sinkhorn_log_geometry as j_log,
    solve as j_solve,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sharded_worker as W  # noqa: E402

WORKER = Path(W.__file__).resolve()
SRC = Path(__file__).resolve().parents[1] / "src"
WORLDS = (1, 2, 3, 4)
DEADLINE_S = 240

_REF4 = """
    import sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.core import (FactoredPositive, GaussianPointCloud,
                            sharded_sinkhorn_geometry)
    sys.path.insert(0, sys.argv[2])
    import torch_sharded_worker as W
    inp = W.inputs()
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    geoms = dict(
        log=GaussianPointCloud.build(inp["x"], inp["y"], inp["anchors"],
                                     eps=0.5, R=W.RADIUS),
        scaling=FactoredPositive(xi=inp["xi"], zeta=inp["zeta"], eps=0.5))
    out = {}
    for mode, g in geoms.items():
        n, m = g.shape
        a, b = np.full(n, 1.0 / n, np.float32), np.full(m, 1.0 / m, np.float32)
        res = sharded_sinkhorn_geometry(mesh, g, a, b, mode=mode, tol=0.0,
                                        max_iter=40)
        out.update({f"{mode}_cost": np.asarray(res.cost),
                    f"{mode}_n_iter": np.asarray(res.n_iter),
                    f"{mode}_f": np.asarray(res.f),
                    f"{mode}_g": np.asarray(res.g)})
    np.savez(sys.argv[1], **out)
"""


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
def worlds(tmp_path_factory):
    """{p: rank results} (or the failure text), {"ref4": ...}, and the
    JAX package's single-device results, all on the same inputs."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    start = time.monotonic()
    procs, logs = {}, []
    for p in WORLDS:
        procs[p] = []
        for r in range(p):
            log = open(tmp / f"log{p}_{r}.txt", "w")
            logs.append(log)
            procs[p].append(subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(p),
                 str(tmp / f"init{p}"), str(tmp / f"out{p}_{r}.pt")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    ref4_log = open(tmp / "ref4.txt", "w")
    logs.append(ref4_log)
    ref4 = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF4),
         str(tmp / "ref4.npz"), str(WORKER.parent)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        stdout=ref4_log, stderr=subprocess.STDOUT)
    try:
        refs = _jax_references(W.inputs())
    finally:
        deadline = start + DEADLINE_S
        out = {}
        for p in WORLDS:
            bad = _finish(procs[p], deadline)
            if bad is None:
                out[p] = [torch.load(tmp / f"out{p}_{r}.pt",
                                     weights_only=False) for r in range(p)]
            else:
                err = tmp / f"out{p}_{bad}.pt.err"
                out[p] = (err.read_text() if bad >= 0 and err.exists()
                          else (tmp / f"log{p}_{max(bad, 0)}.txt").read_text()
                          or "world timed out")
        out["ref4"] = (dict(np.load(tmp / "ref4.npz"))
                       if _finish([ref4], deadline) is None
                       else (tmp / "ref4.txt").read_text())
        for log in logs:
            log.close()
    return out, refs


def _world(worlds, p):
    out, _ = worlds
    ranks = out[p]
    if isinstance(ranks, str):
        pytest.fail(f"world of {p} failed:\n{ranks}")
    return ranks


def _j(v):
    return jnp.asarray(np.asarray(v, np.float32))


def _jgeoms(inp, eps=0.5):
    x, y, u = _j(inp["x"]), _j(inp["y"]), _j(inp["anchors"])
    return dict(
        factored=JFactored(xi=_j(inp["xi"]), zeta=_j(inp["zeta"]), eps=eps),
        log_factored=JFactored(log_xi=_j(inp["log_xi"]),
                               log_zeta=_j(inp["log_zeta"]), eps=eps),
        gaussian=JGaussian.build(x, y, u, eps=eps, R=W.RADIUS),
        arccos=JArcCos(x, y, u, eps=eps))


def _jout(res):
    return dict(cost=float(res.cost), n_iter=int(res.n_iter),
                f=np.asarray(res.f), g=np.asarray(res.g))


def _uniform(g):
    n, m = g.shape
    return jnp.full((n,), 1.0 / n), jnp.full((m,), 1.0 / m)


def _jax_references(inp) -> dict:
    """The JAX package's single-device results on the cases' inputs."""
    geoms = _jgeoms(inp)
    refs = {}

    def local(family, method, eps=0.5, **kw):
        g = _jgeoms(inp, eps)[family]
        return _jout(j_solve(JProblem.from_geometry(g), method=method, **kw))

    refs["factored_scaling"] = local("factored", "factored", tol=1e-6)
    refs["factored_fn"] = refs["row_sharded_factored"] = \
        refs["factored_scaling"]
    refs["factored_log"] = local("log_factored", "log_factored", tol=1e-6)
    refs["gaussian_log"] = local("gaussian", "log_factored", tol=1e-6)
    refs["gaussian_log_plain"] = refs["spec"] = refs["gaussian_log"]
    refs["gaussian_scaling"] = local("gaussian", "factored", tol=1e-6)
    refs["gaussian_small_eps"] = local("gaussian", "log_factored", eps=0.01,
                                       tol=0.0, max_iter=100)
    refs["arccos_log"] = local("arccos", "log_factored", tol=1e-6)
    refs["arccos_scaling"] = local("arccos", "factored", tol=1e-6)
    refs["momentum"] = local("log_factored", "log_factored", tol=1e-5,
                             momentum=1.3)
    a0, b0 = _j(inp["a_zero"]), _j(inp["b_zero"])
    refs["padding_scaling"] = _jout(j_scaling(geoms["factored"], a0, b0,
                                              tol=1e-6))
    refs["padding_log"] = _jout(j_log(geoms["log_factored"], a0, b0,
                                      tol=1e-6))
    a, b = _uniform(geoms["gaussian"])
    refs["fixed_log"] = _jout(j_log(geoms["gaussian"], a, b, tol=0.0,
                                    max_iter=40))
    af, bf = _uniform(geoms["factored"])
    refs["fixed_scaling"] = _jout(j_scaling(geoms["factored"], af, bf,
                                            tol=0.0, max_iter=40))
    refs["cold_1e-6"] = _jout(j_log(geoms["gaussian"], a, b, tol=1e-6))
    refs["auto"] = _jout(j_solve(JProblem.from_geometry(geoms["gaussian"]),
                                 tol=1e-6))
    refs["auto_linear"] = _jout(j_solve(
        JProblem.from_geometry(geoms["factored"]), tol=1e-6))
    refs["solve_many"] = [refs["gaussian_log"], refs["factored_log"]]
    ann = j_solve(JProblem.from_geometry(_jgeoms(inp, eps=0.1)["gaussian"]),
                  schedule=JSchedule(eps_init=1.0, decay=0.5), tol=1e-5)
    refs["annealed"] = _jout(ann)

    def div(x, y, u, a, b):
        return j_div(JGaussian.build(x, y, u, eps=0.5, R=W.RADIUS), a, b,
                     tol=1e-6)

    args = [_j(inp[k]) for k in ("x", "y", "anchors", "a_zero", "b_zero")]
    val, grads = jax.value_and_grad(div, argnums=(0, 1, 2, 3, 4))(*args)
    refs["divergence"] = dict(value=float(val),
                              grads=[np.asarray(g) for g in grads])

    def obj(x, y, u):
        return j_div(JGaussian.build(x, y, u, eps=0.5, R=W.RADIUS), tol=1e-6)

    val, grads = jax.value_and_grad(obj, argnums=(0, 1, 2))(*args[:3])
    refs["objective"] = dict(value=float(val),
                             grads=[np.asarray(g) for g in grads])
    return refs


def _assert_solve(got, want, *, n_tol=0, a=None, b=None):
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-5)
    assert abs(got["n_iter"] - want["n_iter"]) <= n_tol, (got["n_iter"],
                                                          want["n_iter"])
    for pot, w in (("f", a), ("g", b)):
        live = np.ones(want[pot].shape, bool) if w is None \
            else np.asarray(w) > 0
        np.testing.assert_allclose(got[pot][live], want[pot][live],
                                   atol=1e-5, rtol=0)
        assert np.all(got[pot][~live] == -np.inf)
        assert np.all(want[pot][~live] == -np.inf)


def _assert_grads(got, want):
    assert got["value"] == pytest.approx(want["value"], rel=1e-5, abs=1e-7)
    for gt, gj in zip(got["grads"], want["grads"]):
        live = np.isfinite(gj)
        assert np.array_equal(live, np.isfinite(gt))
        np.testing.assert_allclose(gt[live], gj[live], rtol=1e-4, atol=1e-7)


SOLVE_CASES = {
    # case -> |d n_iter| allowed (the point-cloud feature plans: 1)
    "factored_scaling": 0, "factored_fn": 0, "factored_log": 0,
    "row_sharded_factored": 0,
    "gaussian_log": 1, "gaussian_log_plain": 1, "gaussian_scaling": 1,
    "gaussian_small_eps": 0, "arccos_log": 1, "arccos_scaling": 1,
    "momentum": 0, "padding_scaling": 0, "padding_log": 0,
    "fixed_log": 0, "fixed_scaling": 0, "spec": 1,
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_sharded_solve_matches_the_jax_single_device_solve(worlds, world,
                                                           case):
    got = _world(worlds, world)[0][case]
    inp = W.inputs()
    pad = case.startswith("padding")
    _assert_solve(got, worlds[1][case], n_tol=SOLVE_CASES[case],
                  a=inp["a_zero"] if pad else None,
                  b=inp["b_zero"] if pad else None)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["log", "scaling"])
def test_sharded_solve_matches_the_jax_sharded_solver(worlds, world, mode):
    """Against ``repro.core.sharded_sinkhorn_geometry`` itself on 4
    virtual devices (uneven n), 40 fixed iterations."""
    ref4 = worlds[0]["ref4"]
    if isinstance(ref4, str):
        pytest.fail(f"the JAX sharded solver failed:\n{ref4}")
    want = {k: ref4[f"{mode}_{k}"] for k in ("cost", "n_iter", "f", "g")}
    want["cost"], want["n_iter"] = float(want["cost"]), int(want["n_iter"])
    _assert_solve(_world(worlds, world)[0][f"fixed_{mode}"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_results(worlds, world):
    ranks = _world(worlds, world)
    for other in ranks[1:]:
        for case, res in ranks[0].items():
            for key, val in res.items():
                if isinstance(val, list) and val and isinstance(val[0], dict):
                    pairs = [(x[k], y[k]) for x, y in zip(val, other[case][key])
                             for k in x]
                elif isinstance(val, list):
                    pairs = list(zip(val, other[case][key]))
                else:
                    pairs = [(val, other[case][key])]
                for x, y in pairs:
                    x, y = np.asarray(x), np.asarray(y)
                    same = (np.array_equal(x, y, equal_nan=True)
                            if x.dtype.kind == "f" else np.array_equal(x, y))
                    assert same, (case, key)


@pytest.mark.parametrize("world", WORLDS)
def test_warm_started_solve_matches_and_saves_iterations(worlds, world):
    got = _world(worlds, world)[0]["warm"]
    inp = W.inputs()
    g = _jgeoms(inp)["gaussian"]
    a, b = _uniform(g)
    want = _jout(j_log(g, a, b, tol=1e-6, f_init=_j(got["cold_f"]),
                       g_init=_j(got["cold_g"])))
    _assert_solve(got, want, n_tol=1)
    assert got["n_iter"] < worlds[1]["cold_1e-6"]["n_iter"]


@pytest.mark.parametrize("world", WORLDS)
def test_auto_dispatch_takes_the_sharded_twin(worlds, world):
    got = _world(worlds, world)[0]["auto"]
    _assert_solve(got, worlds[1]["auto"], n_tol=1)
    assert got["lin_cost"] == pytest.approx(worlds[1]["auto_linear"]["cost"],
                                            rel=1e-5)
    assert got["modes"] == ["log", "scaling"]


@pytest.mark.parametrize("world", WORLDS)
def test_solve_many_dispatches_each_problem_sharded(worlds, world):
    got = _world(worlds, world)[0]["solve_many"]["results"]
    for res, want, n_tol in zip(got, worlds[1]["solve_many"], (1, 0)):
        _assert_solve(res, want, n_tol=n_tol)


@pytest.mark.parametrize("world", WORLDS)
def test_annealed_solve_on_a_mesh(worlds, world):
    got = _world(worlds, world)[0]["annealed"]
    want = worlds[1]["annealed"]
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-5)
    assert abs(got["n_iter"] - want["n_iter"]) <= len(got["stage_iters"])
    np.testing.assert_allclose(got["f"], want["f"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_divergence_value_and_gradients(worlds, world):
    """Supports, shared anchors and weights (zero on several shards)."""
    _assert_grads(_world(worlds, world)[0]["divergence"],
                  worlds[1]["divergence"])


@pytest.mark.parametrize("world", WORLDS)
def test_objective_with_a_mesh_policy(worlds, world):
    _assert_grads(_world(worlds, world)[0]["objective"],
                  worlds[1]["objective"])


@pytest.mark.parametrize("world", WORLDS)
def test_psum_logsumexp_and_its_gradient(worlds, world):
    """An all -inf column gives -inf, not NaN; the value and the gradient
    (gathered on every rank) are the single-process LSE's
    (``kernels.ref.lse``), whose shift is pinned the same way."""
    from repro_torch.kernels.ref import lse
    got = _world(worlds, world)[0]["psum_lse"]
    inp = W.inputs()
    full = torch.cat([torch.as_tensor(inp["log_xi"])[:, :2],
                      torch.full((W.N, 1), -torch.inf)], dim=1)
    leaf = full.clone().requires_grad_(True)
    want = lse(leaf, dim=0)
    (grad,) = torch.autograd.grad(want[:2].sum(), [leaf])
    assert got["value"][2] == -np.inf
    np.testing.assert_allclose(got["value"][:2], want[:2].detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got["grad"][:W.N], grad.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert np.all(np.isfinite(got["grad"][:W.N, :2]))


REFUSALS = {
    "inner_steps": ("ValueError", "megakernel"),
    "mode": ("ValueError", "mode must be"),
    "axis": ("ValueError", "no axis named 'pod'"),
    "no_log_family": ("ValueError", "no log-domain operators"),
    "nystrom": ("ValueError", "per-row feature structure"),
    "dense": ("ValueError", "per-row feature structure"),
    "grid": ("ValueError", "per-row feature structure"),
    "local_method": ("ValueError", "does not run on a mesh"),
    "many_method": ("ValueError", "supports methods"),
    "no_mesh": ("ValueError", "requires a mesh"),
    "production_mesh": ("RuntimeError", "need 256 devices, have 2"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_sharded_refusals(worlds, name):
    got = _world(worlds, 2)[0][f"refuse:{name}"]
    kind, text = REFUSALS[name]
    assert got["type"] == kind and text in got["message"], got
