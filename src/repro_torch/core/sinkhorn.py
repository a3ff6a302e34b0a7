"""Sinkhorn solvers on any Geometry: scaling space and log domain.

Algorithm 1 of the paper, generic in the kernel operator:

    repeat:  v <- b / K^T u ;  u <- a / K v
    until || v . (K^T u) - b ||_1 < tol

In the log domain the iterates are the potentials (f, g) = eps (log u,
log v) and the factored kernel applies through the exact two-stage LSE.
``use_pallas`` picks the fused plan of ``kernels.ops`` (the hand-written
CUDA kernels on the card, their plain versions on the CPU) or, with
``False``, the geometry's plain torch operators. Every solver ends on a
u-update, so the Eq.-6 dual value is  a . f + b . g  with zero-weight atoms
masked. Counterpart of ``repro.core.sinkhorn``.

:func:`run_marginal_loop` is the eager host loop of the plain operators:
one check block, then one host read of its error. A fused plan's solve
runs the block-and-commit body, :func:`run_check_blocks`, over a
:class:`LoopState` on the device, through its cell's runner
(``core.runners``): on the card a captured CUDA graph of ``K`` blocks a
replay, one host read a replay, the stop exact (the committed result is
the first block that stops, whatever blocks run after it); on the CPU the
same body eagerly, one block a read. With the fused plan on
the card the auto cadence runs 8 iterations per launch of the
megakernel (``kernels.fused_loop``: ``sinkhorn_block`` in scaling space,
``log_sinkhorn_block`` in the log domain) wherever it is admitted, as
the JAX package does on a compiled backend; on the CPU it checks every
iteration, as the JAX package does in interpret mode.

The same body runs P problems stacked on a leading axis (the batched
engine, ``core.api.BatchedSinkhorn``): the carry is ``(P, n)`` / ``(P,
m)``, the state's ``n_iter``, ``err``, ``running`` and ``tol`` are
``(P,)``, each lane commits only while it runs, and the host read stops
when no lane runs. That is the JAX package's ``vmap`` of its
``while_loop``: a stopped lane is frozen, and its result equals its own
solve. :func:`run_lane_loop` is the eager host loop of stacked problems
(one block and one read at a time).

A sharded geometry (``core.sharded``, ``geom.spmd`` set) runs the same
solvers: its plan's collectives and :func:`geometry_reduce`'s all-reduced
error and dual value make every rank leave the loop together; its loop is
the eager host loop (a graph cannot hold a gloo collective).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.ops import (
    check_precision,
    geometry_ops,
    notify_plan_selected,
    relax_log,
    relax_scaling,
)
from ..kernels.ref import ieee_fp32
from .geometry import DenseCost, FactoredPositive, Geometry, _masked_log
from .runners import RUNNERS, CellKey, RunnerCache

__all__ = [
    "SinkhornResult",
    "masked_dual_value",
    "geometry_reduce",
    "make_scaling_step",
    "make_log_step",
    "LoopState",
    "loop_state",
    "run_check_blocks",
    "run_marginal_loop",
    "run_lane_loop",
    "sinkhorn_operator",
    "sinkhorn_geometry",
    "sinkhorn_factored",
    "sinkhorn_quadratic",
    "sinkhorn_log_geometry",
    "sinkhorn_log_factored",
    "sinkhorn_log_quadratic",
]


class SinkhornResult(NamedTuple):
    """Solver output. ``u``/``v`` are scalings; ``f``/``g`` potentials."""

    u: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor             # eps * log u
    g: torch.Tensor             # eps * log v
    cost: torch.Tensor          # W_hat = a.f + b.g   (Eq. 6), 0-d
    n_iter: int
    marginal_err: torch.Tensor  # 0-d
    converged: torch.Tensor     # 0-d bool

    @property
    def diverged(self) -> torch.Tensor:
        """The iteration blew up (non-finite marginal error or dual value)
        rather than merely not converging yet."""
        return ~(torch.isfinite(self.marginal_err) & torch.isfinite(self.cost))

    @property
    def health(self):
        """The :class:`~repro_torch.resilience.health.SolveHealth` verdict
        of one problem's result (``ok`` / ``maxed_out`` / ``diverged``),
        read to the host. ``poisoned_warm_start`` needs the warm start the
        result does not carry: classify through
        :func:`repro_torch.resilience.classify` with ``f_init``/``g_init``
        for it."""
        from ..resilience.health import classify
        return classify(self)


def _f32(x: float) -> float:
    """``x`` rounded to float32: the solvers compare float32 errors."""
    return float(torch.tensor(x, dtype=torch.float32))


def _check_inputs(geom: Geometry, *tensors: torch.Tensor) -> None:
    """Forward solves only: a differentiable input would let autograd trace
    the whole loop and return a gradient that is not the envelope-theorem
    one, so it is refused, as the JAX package cannot reverse-differentiate
    its while_loop either. Gradients go through ``core.grad.rot_geometry``
    (the envelope VJP), e.g. ``sinkhorn_divergence_geometry``."""
    for t in (*geom.tensors(), *(t for t in tensors if t is not None)):
        if t.requires_grad:
            raise NotImplementedError(
                "gradients of a solve are not taken through the loop: "
                "differentiate rot_geometry / sinkhorn_divergence_geometry "
                "(the envelope-theorem VJP), or pass tensors that do not "
                "require grad")
        if t.device != geom.device:
            raise ValueError(f"input on {t.device}, geometry on "
                             f"{geom.device}")


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over a problem's atoms: the whole of a 1-D tensor (0-d), the
    last axis of P stacked problems ((P,))."""
    return torch.sum(x) if x.dim() <= 1 else torch.sum(x, dim=-1)


def masked_dual_value(a, b, f, g, reduce=lane_sum):
    """W_hat = <a, f> + <b, g> with zero-weight atoms excluded (their
    potentials are -inf, and 0 * -inf would be NaN); one value a problem
    for stacked problems. ``reduce`` sums a term (:func:`geometry_reduce`:
    over every rank's atoms for a sharded geometry)."""
    ta = reduce(torch.where(a > 0, a * f, torch.zeros_like(f)))
    tb = reduce(torch.where(b > 0, b * g, torch.zeros_like(g)))
    return ta + tb


def geometry_reduce(geom: Geometry):
    """The sum over a problem's atoms that a geometry's execution implies:
    :func:`lane_sum` on one device; for a sharded geometry (``geom.spmd``
    set) its local sum all-reduced over the mesh axis, so the marginal
    error and the dual value are the same on every rank and every rank
    leaves the loop together."""
    return _sum_over(getattr(geom, "spmd", None))


def _sum_over(spmd):
    if spmd is None:
        return lane_sum
    return lambda x: spmd.sum_(lane_sum(x))


def make_scaling_step(matvec, rmatvec, a, b, *, momentum: float = 1.0,
                      err_reduce=lane_sum):
    """One full Alg.-1 iteration in scaling space:
    ``step((u, v, s)) -> ((u', v', s'), err)`` with ``s = K^T u`` carried.
    Dead (zero-mass) atoms are pinned to scaling 0, so a 0/0 under a dead
    slot never rides the next matvec into the live lanes. ``err_reduce``
    sums the error (:func:`geometry_reduce`)."""
    zero_b, zero_a = torch.zeros_like(b), torch.zeros_like(a)

    def step(carry):
        u, v, s = carry
        v_new = relax_scaling(torch.where(b > 0, b / s, zero_b), v, momentum)
        u_new = relax_scaling(
            torch.where(a > 0, a / matvec(v_new), zero_a), u, momentum)
        s_new = rmatvec(u_new)
        err = err_reduce(torch.abs(v_new * s_new - b))
        return (u_new, v_new, s_new), err

    return step


def make_log_step(log_matvec, log_rmatvec, a, b, *, eps: float,
                  momentum: float = 1.0, err_reduce=lane_sum):
    """One full log-domain iteration: ``step((f, g)) -> ((f', g'), err)``;
    ``err_reduce`` as in :func:`make_scaling_step`."""
    loga, logb = _masked_log(a), _masked_log(b)

    def step(carry):
        f, g = carry
        g = relax_log(eps * (logb - log_rmatvec(f)), g, momentum)
        f = relax_log(eps * (loga - log_matvec(g)), f, momentum)
        log_col = log_rmatvec(f) + g / eps
        err = err_reduce(torch.abs(torch.exp(log_col) - b))
        return (f, g), err

    return step


class LoopState(NamedTuple):
    """The device state of the block-and-commit body. ``carry`` is the
    committed carry, which the next block starts from; ``status`` packs
    ``(running, n_iter)`` as float64 for the loop's one host read. The
    body updates every field in place. A lane is a problem: the lane
    fields are 0-d for one problem and (P,) for P stacked problems."""

    carry: Tuple[torch.Tensor, ...]
    n_iter: torch.Tensor        # int64, per lane: iterations of the carry
    err: torch.Tensor           # float32, per lane: its marginal error
    running: torch.Tensor       # bool, per lane: no block has stopped yet
    tol: torch.Tensor           # float32, per lane
    max_iter: torch.Tensor      # int64, 0-d
    status: torch.Tensor        # float64, (2,) + lanes


def loop_state(carry0, *, tol=None, max_iter: Optional[int] = None,
               lanes: Optional[int] = None) -> LoopState:
    """A new state on the carry's device, its carry shaped like
    ``carry0``, with ``lanes`` problems on the carry's leading axis
    (``None``: one problem, 0-d lane fields); loaded with ``carry0``,
    ``tol`` and ``max_iter`` where ``tol`` is given
    (:func:`load_loop_state`)."""
    dev = carry0[0].device
    lead = () if lanes is None else (int(lanes),)

    def field(dtype, shape=lead):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = LoopState(tuple(torch.empty_like(c) for c in carry0),
                      field(torch.int64), field(torch.float32),
                      field(torch.bool), field(torch.float32),
                      field(torch.int64, ()),
                      field(torch.float64, (2,) + lead))
    if tol is not None:
        load_loop_state(state, carry0, tol=tol, max_iter=max_iter)
    return state


def load_loop_state(state: LoopState, carry0, *, tol,
                    max_iter: int) -> None:
    """Start ``state`` over: the carry ``carry0``, no iteration, running,
    and this solve's ``tol`` (a float, rounded to float32 as the errors
    are, or a float32 tensor of one tolerance a lane) and ``max_iter``."""
    for dst, src in zip(state.carry, carry0):
        dst.copy_(src)
    state.n_iter.zero_()
    state.err.zero_()
    state.running.fill_(True)
    if isinstance(tol, torch.Tensor):
        state.tol.copy_(tol)
    else:
        state.tol.fill_(_f32(tol))
    state.max_iter.fill_(int(max_iter))


def run_check_blocks(step, state: LoopState, *, blocks: int,
                     steps_per_check: int = 1, iters_per_step: int = 1):
    """The block-and-commit body: ``blocks`` check blocks from the
    committed carry, each ``steps_per_check`` calls of ``step`` (each
    advancing ``iters_per_step`` iterations) and then, on the device::

        if running: commit the block's carry, iteration count and error
        running &= tol < err < inf and n < max_iter

    which is the host loop's test after each block (a NaN error stops
    it too), so the committed result is the first block that stops.
    Blocks after it may run, on their own carry, and change nothing that
    is committed, and a call on a stopped state commits nothing. With
    stacked problems each lane commits and stops on its own (a stopped
    lane is frozen), so its result is its own solve's. Reads nothing to
    the host, so a runner captures it in a CUDA graph."""
    cadence = steps_per_check * iters_per_step
    its = state.n_iter.unsqueeze(-1) + torch.arange(
        cadence, cadence * (blocks + 1), cadence, dtype=torch.int64,
        device=state.n_iter.device)
    under_cap = its < state.max_iter
    running = state.running
    carry = state.carry
    for k in range(blocks):
        for _ in range(steps_per_check):
            carry, err = step(carry)
        for dst, src in zip(state.carry, carry):
            torch.where(_lanes_like(running, dst), src, dst, out=dst)
        torch.where(running, its[..., k], state.n_iter, out=state.n_iter)
        torch.where(running, err, state.err, out=state.err)
        finite = torch.nan_to_num(err, nan=-math.inf, posinf=-math.inf)
        running &= (finite > state.tol) & under_cap[..., k]
    torch.stack([running.double(), state.n_iter.double()],
                out=state.status)


def _lanes_like(lanes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A lane field ((P,) or 0-d) shaped to broadcast over a carry ``x``
    whose leading axis holds the lanes."""
    if lanes.dim() == 0:
        return lanes
    return lanes.view(lanes.shape + (1,) * (x.dim() - 1))


def _read_status(state: LoopState):
    """The loop's one host read: ``(done, n_iter)``; with stacked problems
    ``done`` once no lane runs, and ``n_iter`` a list, one count a lane."""
    running, n_iter = state.status.tolist()
    if isinstance(running, list):
        return not any(running), [int(k) for k in n_iter]
    return not running, int(n_iter)


def run_marginal_loop(step, carry0, *, tol: float, max_iter: int,
                      steps_per_check: int = 1, iters_per_step: int = 1):
    """Run ``step`` until the marginal error drops below ``tol``: the
    eager host loop of the plain operators (and of a fused plan's solve
    with ``_FORCE["graphs"]`` off).

    One check block is always taken. Each block calls ``step``
    ``steps_per_check`` times back to back, each call advancing
    ``iters_per_step`` iterations (``inner_steps`` for the megakernel block
    step, 1 otherwise), then reads the error to the host once; the loop
    stops when it is ``<= tol``, is not finite, or ``max_iter`` is reached.
    ``n_iter`` is therefore a multiple of the cadence and ``max_iter``
    rounds up to one. Returns ``(n_iter, carry, err)``."""
    tol = _f32(tol)
    cadence = steps_per_check * iters_per_step

    def block(carry):
        for _ in range(steps_per_check):
            carry, err = step(carry)
        return carry, err

    carry, err = block(carry0)
    it = cadence
    e = float(err)
    while it < max_iter and e > tol and math.isfinite(e):
        carry, err = block(carry)
        it += cadence
        e = float(err)
    return it, carry, err


def run_lane_loop(step, carry0, *, tol, max_iter: int, lanes: int,
                  steps_per_check: int = 1, iters_per_step: int = 1):
    """The eager host loop of ``lanes`` stacked problems: the block-and-
    commit body one block at a time over a fresh state, one host read a
    block, until no lane runs (each lane stops as :func:`run_marginal_loop`
    stops one problem). ``tol`` is a float or one float32 tolerance a lane.
    Returns ``(n_iter, carry, err)``: a list of counts, the committed
    carry and the (P,) errors."""
    state = loop_state(carry0, tol=tol, max_iter=max_iter, lanes=lanes)
    while True:
        run_check_blocks(step, state, blocks=1,
                         steps_per_check=steps_per_check,
                         iters_per_step=iters_per_step)
        done, n_iter = _read_status(state)
        if done:
            return n_iter, state.carry, state.err


# ---------------------------------------------------------------------------
# Plan selection (the use_pallas policy)
# ---------------------------------------------------------------------------


def _maybe_pallas_plan(geom: Geometry, use_pallas: Optional[bool], mode: str,
                       precision: str = "highest"):
    """Resolve ``use_pallas`` into a fused plan or ``None``. ``None`` and
    ``True`` take the plan (kernels on the card, plain versions on the
    CPU); ``False`` the geometry's plain operators. Geometries without a
    fused plan (dense costs) always run their operators."""
    if use_pallas is False:
        return None
    plan = geometry_ops(geom, mode=mode, precision=precision)
    if plan is not None:
        notify_plan_selected({
            "geometry": type(geom).__name__,
            "mode": plan.mode,
            "kind": plan.kind,
            "precision": plan.precision,
        })
    return plan


def _resolve_cadence(plan, inner_steps: Optional[int],
                     check_every: Optional[int]):
    """``(inner, check, auto)``: iterations per megakernel launch and per
    convergence check from the knobs.

    Auto (both ``None``): 8 and 8 when the fused plan runs on the card and
    has a megakernel (``_plan_loop`` still takes the per-iteration step at
    shapes the megakernel does not admit); 1 and 1 everywhere else,
    including the CPU and a plan with no megakernel (the paged plan), as
    the JAX package keeps 1/1 in interpret mode and without a block step.
    Explicit values hold on every path; on the plain operators
    ``inner_steps`` only sets the check cadence."""
    if inner_steps is None and check_every is None:
        if plan is not None and plan.features[0].is_cuda \
                and plan.make_block_step is not None:
            return 8, 8, True
        return 1, 1, True
    inner = 1 if inner_steps is None else int(inner_steps)
    if inner < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    check = inner if check_every is None else int(check_every)
    if check < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if check % inner != 0:
        raise ValueError(
            f"check_every ({check}) must be a multiple of inner_steps "
            f"({inner}): the marginal error only exists at block boundaries")
    return inner, check, False


# ``graphs=False`` runs a fused plan's solve on the card through the eager
# host loop (one block, one host read at a time), the graph path's
# yardstick in chip_smoke.py.
_FORCE = {"graphs": True}

# The most check blocks a replay runs (K). chip_smoke.py's phase 4 times
# its request at K = 2, 4, 8 and 16: 2 reads 36 times a request and 8 ten,
# 16 runs 27 iterations past the stops and 8 eleven; 4 and 8 time alike,
# and 8 keeps a 40-iteration megakernel solve (5 blocks) one replay.
_MAX_REPLAY_BLOCKS = 8


def _replay_blocks(cadence: int, max_iter: int, device: torch.device) -> int:
    """K, the check blocks a replay runs: 1 on the CPU (one block a read);
    on the card ``_MAX_REPLAY_BLOCKS``, or the ``ceil(max_iter / cadence)``
    blocks a solve can take where they are fewer. So every solve whose
    ``max_iter`` spans ``_MAX_REPLAY_BLOCKS`` blocks shares one K (and one
    runner); a replay runs at most K - 1 blocks past a stop, and they
    commit nothing."""
    if device.type != "cuda":
        return 1
    return min(_MAX_REPLAY_BLOCKS, max(1, -(-int(max_iter) // cadence)))


def _run_captured(runners: RunnerCache, key: CellKey, plan, make, a, b,
                  carry0, *, tol, max_iter, steps_per_check,
                  iters_per_step):
    """A fused plan's solve through its cell's runner: copy the operands
    (into buffers the cache shares across runners of their shapes),
    weights and start carry into the runner's buffers, capture the loop on
    the cell's first solve (on the card after one eager block, which is
    this solve's first), then replay K blocks at a time until the committed
    state is done, reading it once a replay. Returns ``(n_iter, carry,
    err)``, copied out of the buffers the next solve reuses."""
    runner = runners.get(key)
    bufs = runner.buffers
    first = not runner.captured
    if first:
        bufs["operands"] = runners.slots(plan.operands)
        bufs["a"], bufs["b"] = torch.empty_like(a), torch.empty_like(b)
        bufs["plan"] = plan.bind(bufs["operands"])
    for dst, src in zip(bufs["operands"], plan.operands):
        dst.copy_(src)
    bufs["a"].copy_(a)
    bufs["b"].copy_(b)
    carry = bufs["plan"].init(*carry0)
    if first:
        bufs["state"] = loop_state(carry, lanes=key.P or None)
    state = bufs["state"]
    load_loop_state(state, carry, tol=tol, max_iter=max_iter)

    def program(blocks=key.blocks):
        step, _ = make(bufs["plan"], bufs["a"], bufs["b"])
        run_check_blocks(step, state, blocks=blocks,
                         steps_per_check=steps_per_check,
                         iters_per_step=iters_per_step)

    # on the card the capture's warm-up block is this solve's first block
    if not (first and runner.capture(program, warmup=lambda: program(1))):
        runner.replay()
    while True:
        runners.reads += 1
        done, n_iter = _read_status(state)
        if done:
            return (n_iter, tuple(c.clone() for c in state.carry),
                    state.err.clone())
        runner.replay()


def _plan_loop(plan, a, b, carry0, *, tol, max_iter, inner_steps,
               check_every, momentum, runners: Optional[RunnerCache] = None):
    """Run a fused plan's hot loop: the megakernel block step
    (``inner_steps`` iterations per launch) where the plan has one and
    admits the shape, else the per-iteration step at the same check
    cadence (every iteration under auto), through the cell's runner of
    ``runners`` (default ``core.runners.RUNNERS``). ``carry0`` is
    ``(u0, v0)`` or ``(f0, g0)``; returns ``(n_iter, carry, err)``. A plan
    over P stacked problems (weights ``(P, n)``) runs its lanes in one
    loop, its ``n_iter`` a list and ``tol`` a float or one a lane; its
    megakernel step advances all P lanes in one launch (one cluster a
    problem) wherever one problem's shape is admitted, and each lane
    commits and stops on its own (:func:`run_check_blocks`)."""
    lanes = a.shape[0] if a.dim() == 2 else None
    n, m = a.shape[-1], b.shape[-1]
    inner, check, auto = _resolve_cadence(plan, inner_steps, check_every)
    if inner > 1 and plan.block_admits(n, m, lanes or 1):
        steps_per_check, iters_per_step = check // inner, inner

        def make(p, a_, b_):
            return p.make_block_step(a_, b_, inner_steps=inner,
                                     momentum=momentum)
    else:
        steps_per_check, iters_per_step = (1 if auto else check), 1

        def make(p, a_, b_):
            return p.make_step(a_, b_, momentum=momentum)
    kw = dict(tol=tol, max_iter=max_iter, steps_per_check=steps_per_check,
              iters_per_step=iters_per_step)
    if not _FORCE["graphs"] or plan.spmd is not None:
        # a sharded plan's collectives run eagerly, one host read a block
        step, init = make(plan, a, b)
        if lanes is not None:
            return run_lane_loop(step, init(*carry0), lanes=lanes, **kw)
        return run_marginal_loop(step, init(*carry0), **kw)
    xi = plan.features[0]
    blocks = _replay_blocks(steps_per_check * iters_per_step, max_iter,
                            a.device)
    key = CellKey(plan.mode, plan.kind, n, m, xi.shape[-1], lanes or 0,
                  xi.dtype, plan.page_size, float(plan.eps),
                  float(momentum), iters_per_step, steps_per_check, blocks,
                  plan.precision, a.device)
    return _run_captured(RUNNERS if runners is None else runners, key, plan,
                         make, a, b, carry0, **kw)


# ---------------------------------------------------------------------------
# Scaling space
# ---------------------------------------------------------------------------


def _converged(err: torch.Tensor, tol) -> torch.Tensor:
    """``err <= tol``, ``tol`` a float (rounded to float32) or a tensor of
    one tolerance a lane."""
    return err <= (tol if isinstance(tol, torch.Tensor) else _f32(tol))


def _finish_scaling(a, b, u, v, it, err, *, eps, tol,
                    reduce=lane_sum) -> SinkhornResult:
    f, g = eps * _masked_log(u), eps * _masked_log(v)
    cost = masked_dual_value(a, b, f, g, reduce)
    return SinkhornResult(u, v, f, g, cost, it, err, _converged(err, tol))


def sinkhorn_operator(matvec, rmatvec, a, b, *, eps: float, tol: float = 1e-6,
                      max_iter: int = 2000, momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None,
                      check_every: int = 1,
                      reduce=lane_sum) -> SinkhornResult:
    """Algorithm 1 on an abstract positive kernel operator; ``reduce`` sums
    over the atoms (:func:`geometry_reduce`)."""
    u0 = torch.ones_like(a) if u_init is None else u_init
    v0 = torch.ones_like(b)
    step = make_scaling_step(matvec, rmatvec, a, b, momentum=momentum,
                             err_reduce=reduce)
    it, (u, v, _), err = run_marginal_loop(
        step, (u0, v0, rmatvec(u0)), tol=tol, max_iter=max_iter,
        steps_per_check=int(check_every))
    return _finish_scaling(a, b, u, v, it, err, eps=eps, tol=tol,
                           reduce=reduce)


def _solve_scaling_plan(plan, a, b, *, eps, tol, max_iter, momentum,
                        u_init, inner_steps=None, check_every=None,
                        runners=None) -> SinkhornResult:
    """Algorithm 1 with the loop body routed through the fused scaling
    plan: the semantics of :func:`sinkhorn_operator` (warm start, marginal
    check, momentum) up to the check cadence. The plan divides ``b / s``
    without the dead-atom pin of :func:`make_scaling_step`, as the JAX
    package's plan does."""
    u0 = torch.ones_like(a) if u_init is None else u_init
    v0 = torch.ones_like(b)
    it, (u, v, _), err = _plan_loop(plan, a, b, (u0, v0), tol=tol,
                                    max_iter=max_iter,
                                    inner_steps=inner_steps,
                                    check_every=check_every,
                                    momentum=momentum, runners=runners)
    return _finish_scaling(a, b, u, v, it, err, eps=eps, tol=tol,
                           reduce=_sum_over(plan.spmd))


def sinkhorn_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
                      tol: float = 1e-6, max_iter: int = 2000,
                      momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None,
                      use_pallas: Optional[bool] = None,
                      inner_steps: Optional[int] = None,
                      check_every: Optional[int] = None,
                      precision: str = "highest",
                      runners: Optional[RunnerCache] = None
                      ) -> SinkhornResult:
    """Algorithm 1 in scaling space on any Geometry.

    With the fused plan (``use_pallas`` not ``False``) a factored or
    point-cloud geometry runs the scaling kernels: per iteration two
    ``feature_contract`` launches, one fused ``sinkhorn_halfstep`` (a
    ``feature_matvec`` and the relaxation at momentum other than 1) and one
    ``feature_matvec`` for the carried ``s = K^T u``; or ``inner_steps``
    iterations in one launch of the megakernel ``sinkhorn_block`` where it
    is admitted (see :func:`_resolve_cadence`). ``use_pallas=False``, and
    dense costs, which have no fused plan, run the geometry's plain torch
    operators. ``precision="bf16"`` stores the factors in bfloat16 with
    float32 accumulation on both paths. ``u_init`` warm-starts u. A fused
    plan's loop runs through its cell's runner of ``runners`` (default
    ``core.runners.RUNNERS``): a captured CUDA graph on the card."""
    check_precision(precision)
    _check_inputs(geom, a, b, u_init)
    plan = _maybe_pallas_plan(geom, use_pallas, "scaling", precision)
    if plan is not None:
        return _solve_scaling_plan(plan, a, b, eps=geom.eps, tol=tol,
                                   max_iter=max_iter, momentum=momentum,
                                   u_init=u_init, inner_steps=inner_steps,
                                   check_every=check_every, runners=runners)
    _, check, _ = _resolve_cadence(None, inner_steps, check_every)
    matvec, rmatvec = geom.operators(precision=precision)
    return sinkhorn_operator(matvec, rmatvec, a, b, eps=geom.eps, tol=tol,
                             max_iter=max_iter, momentum=momentum,
                             u_init=u_init, check_every=check,
                             reduce=geometry_reduce(geom))


def sinkhorn_factored(xi: torch.Tensor, zeta: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, eps: float, tol: float = 1e-6,
                      max_iter: int = 2000, momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None
                      ) -> SinkhornResult:
    """Linear-time Sinkhorn on K = xi zeta^T (the paper's Section 3.1),
    through the fused scaling plan."""
    return sinkhorn_geometry(FactoredPositive(xi=xi, zeta=zeta, eps=eps), a,
                             b, tol=tol, max_iter=max_iter,
                             momentum=momentum, u_init=u_init)


def sinkhorn_quadratic(K: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                       eps: float, tol: float = 1e-6, max_iter: int = 2000,
                       momentum: float = 1.0,
                       u_init: Optional[torch.Tensor] = None
                       ) -> SinkhornResult:
    """The paper's ``Sin`` baseline (Cuturi '13): dense O(nm) matvecs on
    the (n, m) Gibbs kernel ``K``."""
    def matvec(v):
        with ieee_fp32():
            return K @ v

    def rmatvec(u):
        with ieee_fp32():
            return K.T @ u

    return sinkhorn_operator(matvec, rmatvec, a, b, eps=eps, tol=tol,
                             max_iter=max_iter, momentum=momentum,
                             u_init=u_init)


# ---------------------------------------------------------------------------
# Log domain (small-eps safe)
# ---------------------------------------------------------------------------


def _log_init(a, b, f_init, g_init):
    """Initial potentials, with zero-weight atoms pinned to -inf so padding
    is exact from iteration 0."""
    f0 = torch.zeros_like(a) if f_init is None else f_init
    g0 = torch.zeros_like(b) if g_init is None else g_init
    f0 = torch.where(a > 0, f0, torch.full_like(f0, -torch.inf))
    g0 = torch.where(b > 0, g0, torch.full_like(g0, -torch.inf))
    return f0, g0


def _finish_log(a, b, f, g, it, err, *, eps, tol,
                reduce=lane_sum) -> SinkhornResult:
    cost = masked_dual_value(a, b, f, g, reduce)
    u, v = torch.exp(f / eps), torch.exp(g / eps)
    return SinkhornResult(u, v, f, g, cost, it, err, _converged(err, tol))


def _solve_log_plan(plan, a, b, *, eps, tol, max_iter, momentum, f_init,
                    g_init, inner_steps=None, check_every=None,
                    runners=None) -> SinkhornResult:
    """The log-domain solve with the loop body routed through the fused
    log plan (:func:`sinkhorn_log_geometry`'s plan path)."""
    f0, g0 = _log_init(a, b, f_init, g_init)
    it, carry, err = _plan_loop(plan, a, b, (f0, g0), tol=tol,
                                max_iter=max_iter, inner_steps=inner_steps,
                                check_every=check_every, momentum=momentum,
                                runners=runners)
    return _finish_log(a, b, carry[0], carry[1], it, err, eps=eps, tol=tol,
                       reduce=_sum_over(plan.spmd))


def sinkhorn_log_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
                          tol: float = 1e-6, max_iter: int = 2000,
                          momentum: float = 1.0,
                          f_init: Optional[torch.Tensor] = None,
                          g_init: Optional[torch.Tensor] = None,
                          use_pallas: Optional[bool] = None,
                          inner_steps: Optional[int] = None,
                          check_every: Optional[int] = None,
                          precision: str = "highest",
                          runners: Optional[RunnerCache] = None
                          ) -> SinkhornResult:
    """Log-domain Sinkhorn on any log-capable Geometry.

    With the fused plan (``use_pallas`` not ``False``) each iteration runs
    the log kernels: three ``log_halfstep`` and two ``log_feature_contract``
    launches, the stage-1 LSE carried so the convergence check costs one
    half-step; or ``inner_steps`` iterations run in one launch of the
    megakernel (see :func:`_resolve_cadence`). ``precision="bf16"`` stores
    the factors in bfloat16 with float32 accumulation, on the plan and on
    the plain operators alike. ``f_init``/``g_init`` warm-start the
    potentials; ``runners`` as in :func:`sinkhorn_geometry`."""
    check_precision(precision)
    _check_inputs(geom, a, b, f_init, g_init)
    plan = _maybe_pallas_plan(geom, use_pallas, "log", precision)
    if plan is not None:
        return _solve_log_plan(plan, a, b, eps=geom.eps, tol=tol,
                               max_iter=max_iter, momentum=momentum,
                               f_init=f_init, g_init=g_init,
                               inner_steps=inner_steps,
                               check_every=check_every, runners=runners)
    f0, g0 = _log_init(a, b, f_init, g_init)
    _, check, _ = _resolve_cadence(None, inner_steps, check_every)
    log_matvec, log_rmatvec = geom.log_operators(precision=precision)
    reduce = geometry_reduce(geom)
    step = make_log_step(log_matvec, log_rmatvec, a, b, eps=geom.eps,
                         momentum=momentum, err_reduce=reduce)
    it, carry, err = run_marginal_loop(step, (f0, g0), tol=tol,
                                       max_iter=max_iter,
                                       steps_per_check=check)
    return _finish_log(a, b, carry[0], carry[1], it, err, eps=geom.eps,
                       tol=tol, reduce=reduce)


def sinkhorn_log_factored(log_xi: torch.Tensor, log_zeta: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor, *, eps: float,
                          tol: float = 1e-6, max_iter: int = 2000,
                          f_init: Optional[torch.Tensor] = None,
                          g_init: Optional[torch.Tensor] = None
                          ) -> SinkhornResult:
    """Log-stabilized linear Sinkhorn on K = exp(log_xi) exp(log_zeta)^T
    through the exact two-stage LSE, O(r (n + m)) an iteration: the fused
    log plan (the log kernels on the card), as ``method="log_factored"``
    runs it. ``f_init``/``g_init`` warm-start the potentials."""
    return sinkhorn_log_geometry(
        FactoredPositive(log_xi=log_xi, log_zeta=log_zeta, eps=eps), a, b,
        tol=tol, max_iter=max_iter, f_init=f_init, g_init=g_init)


def sinkhorn_log_quadratic(C: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           *, eps: float, tol: float = 1e-6,
                           max_iter: int = 5000,
                           f_init: Optional[torch.Tensor] = None,
                           g_init: Optional[torch.Tensor] = None
                           ) -> SinkhornResult:
    """Dense log-domain Sinkhorn on the (n, m) cost ``C``: the oracle."""
    return sinkhorn_log_geometry(DenseCost(C, eps), a, b, tol=tol,
                                 max_iter=max_iter, f_init=f_init,
                                 g_init=g_init)
