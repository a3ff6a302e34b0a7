"""The solve loop as the card runs it, on the CPU: the block-and-commit body
that a runner captures in a CUDA graph, against the host loop and the JAX
package's ``run_marginal_loop``; the runner cache (reuse, keys, LRU, the
launch counts a replay adds); ``StreamingSolver.traces`` and the trainer's
``--strict`` zero-capture check.

The body run K blocks at a time must give the host loop's ``n_iter``
exactly and its carries bit for bit (the committed carry is the first
block that stops); against the JAX loop it holds the North star's bar:
the same ``n_iter`` and the iterates within float32 rounding.
"""
import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sinkhorn as jsk
from repro.core.geometry import FactoredPositive as JFactored
from repro_torch import kernels
from repro_torch.core import FactoredPositive, sinkhorn_geometry
from repro_torch.core import runners as rn
from repro_torch.core import sinkhorn as sk
from repro_torch.core.sinkhorn import (
    loop_state,
    run_check_blocks,
    run_marginal_loop,
    sinkhorn_log_geometry,
)
from repro_torch.kernels.ops import geometry_ops

N, M, R, EPS = 48, 40, 16, 0.5


def _problem(seed=0, dead_row=False):
    rng = np.random.default_rng(seed)
    # log-normal features: a kernel far from rank one, so the solves take
    # tens of iterations to their tolerances
    xi = np.exp(3.0 * rng.standard_normal((N, R))).astype(np.float32)
    zeta = np.exp(3.0 * rng.standard_normal((M, R))).astype(np.float32)
    if dead_row:                 # a live atom no feature reaches: 0 / 0
        zeta[3] = 0.0
    a = rng.uniform(0.5, 1.5, N).astype(np.float32)
    b = rng.uniform(0.5, 1.5, M).astype(np.float32)
    return xi, zeta, a / a.sum(), b / b.sum()


def _blocks_loop(step, carry0, *, blocks, tol, max_iter, steps_per_check=1,
                 iters_per_step=1):
    """The graph path's loop, eagerly: ``blocks`` check blocks a call of
    the body, one read of the committed state after each."""
    state = loop_state(carry0, tol=tol, max_iter=max_iter)
    reads = 0
    while True:
        run_check_blocks(step, state, blocks=blocks,
                         steps_per_check=steps_per_check,
                         iters_per_step=iters_per_step)
        reads += 1
        running, n_iter = state.status.tolist()
        if not running:
            return int(n_iter), state.carry, state.err, reads


def _poison_after(step, k):
    """``step`` whose k-th call returns a NaN carry and error."""
    calls = [0]

    def poisoned(carry):
        calls[0] += 1
        carry, err = step(carry)
        if calls[0] >= k:
            carry = tuple(torch.full_like(c, math.nan) for c in carry)
            err = torch.full_like(err, math.nan)
        return carry, err

    return poisoned


# case -> (mode, momentum, tol, max_iter, steps_per_check, dead_row, jax)
CASES = {
    "stop_mid_graph": ("scaling", 1.0, None, 500, 1, False, True),
    "max_iter_ragged": ("scaling", 1.0, 0.0, 10, 4, False, True),
    "nan_first_block": ("scaling", 1.0, 1e-6, 100, 1, True, True),
    "nan_mid_run": ("log", 1.0, 1e-6, 100, 1, False, False),
    "stop_first_block": ("log", 1.0, 1e9, 100, 1, False, True),
    "momentum_1_3": ("log", 1.3, 1e-5, 500, 1, False, True),
    "cadence_8_8": ("log", 1.0, 1e-6, 400, 1, False, True),
}


def _port_step(case):
    """The case's step (the fused plan's on the CPU, the megakernel block
    step for the 8/8 cadence), its start carry and loop keywords."""
    mode, mom, tol, max_iter, spc, dead, _ = CASES[case]
    xi, zeta, a, b = (torch.as_tensor(v) for v in _problem(dead_row=dead))
    geom = FactoredPositive(xi=xi, zeta=zeta, eps=EPS)
    plan = geometry_ops(geom, mode=mode)
    kw = dict(max_iter=max_iter, steps_per_check=spc)
    if case == "cadence_8_8":
        step, init = plan.make_block_step(a, b, inner_steps=8, momentum=mom)
        kw["iters_per_step"] = 8
    else:
        step, init = plan.make_step(a, b, momentum=mom)
    if mode == "scaling":
        carry0 = init(torch.ones_like(a), torch.ones_like(b))
    else:
        carry0 = init(torch.zeros_like(a), torch.zeros_like(b))
    if case == "nan_mid_run":
        step = _poison_after(step, 6)
    if tol is None:          # between the errors after 9 and 10 iterations
        errs, carry = [], carry0   # (a third of a decade apart): a stop
        for _ in range(10):        # inside the second replay of 8 blocks
            carry, err = step(carry)
            errs.append(float(err))
        tol = math.sqrt(errs[-2] * errs[-1])
    return step, carry0, dict(kw, tol=tol)


def _jax_loop(case, tol):
    """The JAX package's ``run_marginal_loop`` on the same problem, with
    its plain operators (the 8/8 cadence as 8 unfused steps a check)."""
    mode, mom, _, max_iter, spc, dead, _ = CASES[case]
    xi, zeta, a, b = (jnp.asarray(v) for v in _problem(dead_row=dead))
    geom = JFactored(xi=xi, zeta=zeta, eps=EPS)
    if mode == "scaling":
        matvec, rmatvec = geom.operators()
        step = jsk.make_scaling_step(matvec, rmatvec, a, b, momentum=mom)
        u0 = jnp.ones_like(a)
        carry0 = (u0, jnp.ones_like(b), rmatvec(u0))
    else:
        lmv, lrmv = geom.log_operators()
        step = jsk.make_log_step(lmv, lrmv, a, b, eps=EPS, momentum=mom)
        carry0 = (jnp.zeros_like(a), jnp.zeros_like(b))
    if case == "cadence_8_8":
        spc = 8
    return jsk.run_marginal_loop(step, carry0, tol=tol, max_iter=max_iter,
                                 dtype=jnp.float32, steps_per_check=spc)


@pytest.mark.parametrize("blocks", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocks_match_host_loop_and_jax(case, blocks):
    # each loop gets its own step (the poisoned one counts its calls)
    step, carry0, kw = _port_step(case)
    want_it, want, want_err = run_marginal_loop(step, carry0, **kw)
    step, carry0, kw = _port_step(case)
    it, got, err, reads = _blocks_loop(step, carry0, blocks=blocks, **kw)
    assert it == want_it
    assert reads == -(-(want_it // kw.get("iters_per_step", 1)
                        // kw["steps_per_check"]) // blocks)
    for g, w in zip(got, want):
        assert torch.equal(g, w) or (torch.isnan(g).all()
                                     and torch.isnan(w).all())
    np.testing.assert_array_equal(err.numpy(), want_err.numpy())
    if case == "stop_mid_graph":
        assert want_it == 10
    if case == "max_iter_ragged":
        assert want_it == 12               # max_iter rounds up to a block
    if case.startswith("nan"):
        assert not math.isfinite(float(err))
        assert want_it == (1 if case == "nan_first_block" else 6)
    if case == "stop_first_block":
        assert want_it == 1
    if not CASES[case][-1]:
        return
    j_it, j_carry, j_err = _jax_loop(case, kw["tol"])
    assert int(j_it) == it
    if not math.isfinite(float(err)):
        assert not math.isfinite(float(j_err))
        return
    for g, w in zip(got[:2], j_carry[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


def test_body_reads_nothing_to_the_host(monkeypatch):
    """The body and the plans' steps (what a runner captures) never read a
    tensor value to the host: with every reading method made to raise,
    the body still runs."""
    steps = []
    for mode in ("scaling", "log"):
        xi, zeta, a, b = (torch.as_tensor(v) for v in _problem())
        plan = geometry_ops(FactoredPositive(xi=xi, zeta=zeta, eps=EPS),
                            mode=mode)
        ones = (torch.ones_like(a), torch.ones_like(b))
        step, init = plan.make_step(a, b, momentum=1.3)
        steps.append((step, init(*ones)))
        block, init = plan.make_block_step(a, b, inner_steps=8)
        steps.append((block, init(*ones)))
    states = [(step, loop_state(c, tol=0.0, max_iter=50))
              for step, c in steps]

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor value was read to the host")

    for name in ("item", "tolist", "__float__", "__int__", "__bool__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for step, state in states:
        run_check_blocks(step, state, blocks=3)
    monkeypatch.undo()
    assert all(int(state.n_iter) == 3 for _, state in states)


# ---------------------------------------------------------------------------
# The runner cache
# ---------------------------------------------------------------------------


def _solve(cache, *, eps=EPS, tol=1e-6, max_iter=2000, n=N, seed=0,
           mode="log"):
    xi, zeta, a, b = (torch.as_tensor(v) for v in _problem(seed))
    geom = FactoredPositive(xi=xi[:n], zeta=zeta, eps=eps)
    a = a[:n] / a[:n].sum()
    run = sinkhorn_log_geometry if mode == "log" else sinkhorn_geometry
    return run(geom, a, b, tol=tol, max_iter=max_iter, runners=cache)


def test_same_cell_reuses_its_runner():
    cache = rn.RunnerCache()
    first = _solve(cache)
    again = _solve(cache)
    other = _solve(cache, seed=1)         # new data, the same cell
    assert cache.stats()["captures"] == 1 and len(cache) == 1
    assert cache.hits == 2
    assert cache.replays == cache.reads == \
        first.n_iter + again.n_iter + other.n_iter   # K = 1 on the CPU
    assert torch.equal(first.f, again.f) and first.n_iter == again.n_iter
    assert not torch.equal(first.f, other.f)


def test_tol_and_max_iter_do_not_build_a_runner():
    cache = rn.RunnerCache()
    loose = _solve(cache, tol=1e-3)
    tight = _solve(cache, tol=1e-6, max_iter=400)
    capped = _solve(cache, tol=0.0, max_iter=7)
    assert cache.captures == 1 and len(cache) == 1
    assert loose.n_iter < tight.n_iter and capped.n_iter == 7
    # on the card every max_iter that spans 8 check blocks gives K = 8, so
    # one key; a cap of fewer blocks runs that many a replay
    card = torch.device("cuda", 0)
    ks = {sk._replay_blocks(c, it, card) for c in (1, 8)
          for it in (8 * c, 400, 1001, 2000, 2001)}
    assert ks == {sk._MAX_REPLAY_BLOCKS} == {8}
    real, keys = sk._replay_blocks, set()
    for max_iter in (1001, 2000):             # K as on the card
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sk, "_replay_blocks",
                       lambda cadence, it, dev: real(cadence, it, card))
            cache = rn.RunnerCache()
            _solve(cache, tol=1e-3, max_iter=max_iter)
            keys |= set(cache.keys())
    assert len(keys) == 1 and next(iter(keys)).blocks == 8
    assert sk._replay_blocks(8, 40, card) == 5        # the trainer's solves
    assert sk._replay_blocks(1, 3, card) == 3
    assert sk._replay_blocks(1, 2000, torch.device("cpu")) == 1


def test_new_eps_or_shape_builds_a_runner():
    cache = rn.RunnerCache()
    _solve(cache)
    _solve(cache, eps=0.25)
    _solve(cache, n=N - 8)
    _solve(cache, mode="scaling")
    assert cache.captures == 4 and len(cache) == 4
    assert {(k.mode, k.n, k.eps) for k in cache.keys()} == {
        ("log", N, EPS), ("log", N, 0.25), ("log", N - 8, EPS),
        ("scaling", N, EPS)}


def test_lru_evicts_at_max_runners():
    cache = rn.RunnerCache(max_runners=2)
    _solve(cache, eps=1.0)
    _solve(cache, eps=0.5)
    _solve(cache, eps=1.0)                  # most recently used again
    _solve(cache, eps=0.25)                 # evicts eps 0.5
    assert [k.eps for k in cache.keys()] == [1.0, 0.25]
    assert cache.captures == 3
    _solve(cache, eps=0.5)                  # gone: captured again
    assert cache.captures == 4 and [k.eps for k in cache.keys()] == [0.25,
                                                                      0.5]
    with pytest.raises(ValueError):
        rn.RunnerCache(max_runners=0)


def test_runners_of_one_shape_share_their_operand_buffers():
    """Two eps of one shape: two runners over one copy of the factors,
    and each solve still its own (the operands are copied in anew)."""
    cache = rn.RunnerCache()
    first = _solve(cache, eps=0.5)
    _solve(cache, eps=0.25)
    again = _solve(cache, eps=0.5)
    a, b = (r.buffers["operands"] for r in cache._runners.values())
    assert all(x is y for x, y in zip(a, b))
    del a, b
    assert first.n_iter == again.n_iter and torch.equal(first.f, again.f)
    one = rn.RunnerCache()
    _solve(one, eps=0.5)
    assert cache.nbytes < 2 * one.nbytes
    cache.clear()
    assert cache.nbytes == 0 and len(cache._slots) == 0


def test_byte_bound_evicts_the_least_recently_used(monkeypatch):
    one = rn.RunnerCache()
    _solve(one)
    cell = one.nbytes
    monkeypatch.setattr(rn, "MAX_BYTES", cell + cell // 2)
    cache = rn.RunnerCache()
    _solve(cache)                           # within the bound
    _solve(cache, n=N - 8)                  # both past it: the first goes
    assert [k.n for k in cache.keys()] == [N - 8] and cache.captures == 2
    assert cache.nbytes <= rn.MAX_BYTES
    monkeypatch.setattr(rn, "MAX_BYTES", 1)
    tiny = rn.RunnerCache()                 # the newest runner always stays
    _solve(tiny)
    _solve(tiny)
    assert len(tiny) == 1 and tiny.captures == 1 and tiny.hits == 1


def test_a_nine_stage_schedule_keeps_its_runners():
    """The solves' cache holds an annealing schedule's nine stages, so a
    second request captures nothing."""
    from repro_torch.core import EpsSchedule, GaussianFeatureMap, OTProblem
    from repro_torch.core import solve
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((N, 2)) + 1.0).astype(np.float32)
    y = (0.3 * rng.standard_normal((M, 2))).astype(np.float32)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    fm = GaussianFeatureMap(r=16, d=2, eps=0.1, R=R)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((16, 2))).astype(
        np.float32)
    prob = OTProblem.from_point_clouds(x, y, u, eps=0.1, R=R, device="cpu")
    schedule = EpsSchedule(eps_init=1.0, decay=0.75)
    assert len(schedule.stages(0.1)) == 9
    rn.RUNNERS.clear()
    try:
        first = solve(prob, schedule=schedule, tol=1e-4)
        captures = rn.RUNNERS.captures
        again = solve(prob, schedule=schedule, tol=1e-4)
        assert rn.RUNNERS.captures == captures and len(rn.RUNNERS) == 9
        assert again.n_iter == first.n_iter
        assert torch.equal(again.f, first.f)
    finally:
        rn.RUNNERS.clear()


@pytest.mark.parametrize("blocks", [3, 8])
def test_runner_replays_k_blocks_like_the_eager_loop(monkeypatch, blocks):
    """A runner whose replays run K blocks (as on the card) gives the
    eager loop's result bit for bit, in ceil(checks / K) reads."""
    with monkeypatch.context() as mp:
        mp.setitem(sk._FORCE, "graphs", False)
        want = _solve(None, tol=1e-5)
    monkeypatch.setattr(sk, "_replay_blocks", lambda *args: blocks)
    cache = rn.RunnerCache()
    got = _solve(cache, tol=1e-5)
    assert got.n_iter == want.n_iter
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
    assert torch.equal(got.marginal_err, want.marginal_err)
    assert cache.reads == cache.replays == -(-want.n_iter // blocks)
    assert next(iter(cache.keys())).blocks == blocks


def test_a_replay_adds_its_graph_launches(monkeypatch):
    """A captured graph's launches reach the counters at each replay (the
    wrappers themselves run only at capture)."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    cache = rn.RunnerCache()
    runner = cache.get(next(iter(_cell_keys())))
    runner.graph, runner.program = Graph(), lambda: None
    runner.per_replay = {"log_halfstep": 3, "log_feature_contract": 2}
    before = kernels.launch_counts()
    runner.replay()
    runner.replay()
    after = kernels.launch_counts()
    assert after["log_halfstep"] - before["log_halfstep"] == 6
    assert after["log_feature_contract"] - \
        before["log_feature_contract"] == 4
    assert cache.replays == 2 and runner.replays == 2
    kernels.set_launch_counts(before)


def _cell_keys():
    cache = rn.RunnerCache()
    _solve(cache)
    return cache.keys()


# ---------------------------------------------------------------------------
# The retrace gates: StreamingSolver.traces and ot_gan --strict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["scaling", "log"])
def test_streaming_traces_flat_after_warmup(method):
    """Warmup captures the pair's runner; a cold solve, warm updates and a
    cold fallback (a poisoned warm start retried cold) replay it."""
    from repro_torch.streaming import StreamingDistribution, StreamingSolver
    rng = np.random.default_rng(0)
    n, r = 40, 8
    dists = [StreamingDistribution.from_features(
        [(s, i) for i in range(n)],
        (rng.uniform(size=(n, r)) + 0.05).astype(np.float32),
        np.ones(n, np.float32), eps=EPS, device="cpu") for s in "xy"]
    solver = StreamingSolver(method=method, tol=1e-5, max_runners=8)
    pair = solver.register("p", *dists)
    assert solver.traces == 0
    solver.warmup(pair)
    assert solver.traces == 1
    solver.cold_solve(pair)
    for k in range(3):
        res = solver.update(pair, remove_x=[("x", k)], add_x=dict(
            ids=[("new", k)],
            feats=(rng.uniform(size=(1, r)) + 0.05).astype(np.float32),
            weights=np.ones(1, np.float32)))
        assert bool(res.converged)
    pair.f = np.full_like(pair.f, 3e38)          # f / eps overflows
    res = solver.re_solve(pair)
    assert solver.cold_fallbacks == 1 and bool(res.converged)
    assert solver.traces == 1
    assert solver.stats()["traces"] == 1 and solver.stats()["runners"] == 1
    cap = dists[0].capacity
    assert solver.runner_keys == ((cap, dists[1].capacity, r, 64, EPS,
                                   method),)


def test_ot_gan_strict_on_the_cpu():
    from repro_torch.examples import ot_gan
    out = ot_gan.main(["--device", "cpu", "--strict", "--steps", "12",
                       "--batch", "32", "--r", "16", "--iters", "10"])
    assert out["captures"] == 0
    assert out["warmup_launches"] == 0          # plain versions on the CPU
    assert all(math.isfinite(d) for d in out["divergences"])
