"""repro_torch's dry run (``launch.analysis``, ``launch.dryrun``) against the
JAX package's XLA tooling, on the CPU.

* The ring factors and the roofline terms equal the reference's
  ``hlo_analysis.parse_collectives`` / ``roofline_terms`` on the same
  collectives (HLO lines on the JAX side) and the same hardware numbers.
* On a fake world of 16 ranks, a toy function with known ``psum``,
  ``all_gather``, ``all_to_all`` and ``psum_logsumexp`` calls gives exact
  collective counts, result bytes and wire bytes.
* A Python loop of k products counts k times (the loop-aware count), and
  the raw count is ``FlopCounterMode``'s; live bytes rise and fall with
  the storages.
* A tol-0 solve on fake tensors runs ``max_iter`` iterations with no host
  read, on the fused plan and on the plain operators.
* Against the reference's ``make_train_step``, lowered and compiled in
  subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
  (``tests/torch_dryrun_reference.py``; ``repro.launch.dryrun`` is never
  imported here, it sets ``XLA_FLAGS``), at tiny widths (dense, and the MoE
  with EP, MLA and the Sinkhorn router): the rank's parameter and moment
  bytes equal the per-device bytes of the reference's shardings on 1 x 1,
  4 x 1 and 2 x 2; dot FLOPs a device within 5% of ``analyze_hlo``'s on
  1 x 1, 4 x 1 and 2 x 2 (where each ``"model"`` rank computes its
  segment of the sequence, as the reference's), and equal to them
  without the OT loss.
* Decode and prefill cells (expert parallel prefill, a replicated
  one-row decode) run dry with no host read.
* ``run_cell`` writes the full-width production cell smollm-135m x
  train_4k x 16 x 16 on a fake world of 256.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.symbolic_shapes import ShapeEnv
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as REF
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core import BatchedSinkhorn
from repro_torch.core import sinkhorn as SK
from repro_torch.core.geometry import FactoredPositive
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.analysis import HW, StepCounter, roofline_terms, \
    wire_bytes
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import _rows, make_train_step

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import torch_dryrun_reference as R  # noqa: E402

SRC = TESTS.parent / "src"
MESHES = ("1x1", "4x1", "2x2")
FLOP_RTOL = 0.05          # dot FLOPs a device against analyze_hlo's
DEADLINE_S = 420
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: the reference's
    compilations run beside it on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """{mesh: the reference's counts}, or the failure's log; the three
    processes start with the file's first test and compile while the
    port's side runs (the tests that compare come last)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    path = os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {}
    for mesh in MESHES:
        log = open(tmp / f"{mesh}.txt", "w")
        procs[mesh] = (subprocess.Popen(
            [sys.executable, str(TESTS / "torch_dryrun_reference.py"), mesh,
             str(tmp / f"{mesh}.json")], env=env, stdout=log,
            stderr=subprocess.STDOUT), log)
    return _Pending(procs, tmp)


class _Pending:
    """The reference's results, each waited for on its first use."""

    def __init__(self, procs, tmp):
        self.procs, self.tmp, self.done = procs, tmp, {}
        self.deadline = time.monotonic() + DEADLINE_S

    def __getitem__(self, mesh):
        if mesh not in self.done:
            proc, log = self.procs[mesh]
            try:
                proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            self.done[mesh] = (
                json.loads((self.tmp / f"{mesh}.json").read_text())
                if proc.returncode == 0
                else (self.tmp / f"{mesh}.txt").read_text())
        got = self.done[mesh]
        assert isinstance(got, dict), got[-3000:]
        return got


_PORT = {}


def port_counts(case: str, mesh: str):
    """The port's dry run of the reference's case: the rank's parameter
    and moment bytes and its dot FLOPs (cached across the tests)."""
    if (case, mesh) not in _PORT:
        arch, kw = R.CASES[case]
        cfg = get_config(arch).tiny(**kw)
        shape = ShapeSpec("t", R.SEQ, R.BATCH, "train")
        data, model = (int(x) for x in mesh.split("x"))
        with DR.fake_world(data * model):
            m = make_local_mesh(data, model, device="cpu")
            counter, _ = DR.dry_step(cfg, shape, m, micro_batches=R.MICRO)
            step, specs = make_train_step(cfg, m, shape,
                                          micro_batches=R.MICRO)
            with FakeTensorMode(shape_env=ShapeEnv()):
                params, opt, _ = DR.fake_arguments(cfg, shape, step, specs)
                _PORT[case, mesh] = {
                    "param_bytes": _bytes(params),
                    "moment_bytes": _bytes((opt.m, opt.v)),
                    "flops": counter.dot_flops,
                }
    return _PORT[case, mesh]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Ring factors and the roofline
# ---------------------------------------------------------------------------


def _hlo_line(kind: str, group: int) -> str:
    ranks = ",".join(str(i) for i in range(group))
    return (f"  %c = f32[64,32]{{1,0}} {kind}(f32[64,32]{{1,0}} %p), "
            f"replica_groups={{{{{ranks}}}}}")


@pytest.mark.parametrize("kind", KINDS)
def test_ring_factors_equal_the_reference(kind):
    for group in (2, 4, 16):
        ref = REF.parse_collectives(_hlo_line(kind, group), 16)
        assert ref.counts == {kind: 1}
        assert ref.bytes_by_kind == {kind: 64 * 32 * 4}
        assert wire_bytes(kind, 64 * 32 * 4, group) == ref.wire_bytes


def test_roofline_terms_equal_the_reference():
    hw = HW()
    ref_hw = REF.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                    ici_bw=hw.link_bw)
    for terms in ((1e15, 1e9, 1e6), (1e9, 1e13, 1e6), (1e9, 1e9, 1e12)):
        assert roofline_terms(*terms) == REF.roofline_terms(*terms, ref_hw)
    assert {roofline_terms(*t)["dominant"] for t in (
        (1e15, 1e9, 1e6), (1e9, 1e13, 1e6), (1e9, 1e9, 1e12))} == \
        {"compute", "memory", "collective"}


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def test_collectives_are_counted_exactly_on_a_fake_world_of_16():
    """psum over "data" (4), all_gather over "model" (4), all_to_all over
    "data" and psum_logsumexp over the world (16, two all-reduces) of a
    (8, 32) float32 block (1024 bytes)."""
    with DR.fake_world(16):
        ctx = SH.mesh_context(make_local_mesh(4, 4, device="cpu"))
        data, model = ctx.axis("data"), ctx.axis("model")
        counter = StepCounter()
        with FakeTensorMode(shape_env=ShapeEnv()):
            x = torch.empty(8, 32)
            with counter:
                SH.psum(x, data)
                SH.all_gather(x, model, dim=0)
                SH.all_to_all(x.reshape(4, 2, 32), data)
                SH.psum_logsumexp(x, ctx.world, dim=0)
    assert counter.counts == {"all-reduce": 3, "all-gather": 1,
                              "all-to-all": 1}
    assert counter.result_bytes == {"all-reduce": 1024 + 2 * 128,
                                    "all-gather": 4 * 1024,
                                    "all-to-all": 1024}
    want = (2 * 1024 * 3 / 4 + 4 * 1024 * 3 / 4 + 1024 * 3 / 4
            + 2 * (2 * 128 * 15 / 16))
    assert counter.wire_bytes == want
    hlo = "\n".join([
        "  %a = f32[8,32]{1,0} all-reduce(f32[8,32]{1,0} %x), "
        "replica_groups={{0,4,8,12}}",
        "  %b = f32[32,32]{1,0} all-gather(f32[8,32]{1,0} %x), "
        "replica_groups={{0,1,2,3}}",
        "  %c = f32[4,2,32]{2,1,0} all-to-all(f32[4,2,32]{2,1,0} %y), "
        "replica_groups={{0,4,8,12}}",
        "  %d = f32[32]{0} all-reduce(f32[32]{0} %m), replica_groups={}",
        "  %e = f32[32]{0} all-reduce(f32[32]{0} %s), replica_groups={}"])
    ref = REF.parse_collectives(hlo, 16)
    assert ref.counts == counter.counts
    assert ref.bytes_by_kind == counter.result_bytes
    assert ref.wire_bytes == counter.wire_bytes


@pytest.mark.parametrize("k", (1, 4))
def test_a_python_loop_of_k_products_counts_k_times(k):
    a, b = torch.randn(16, 24), torch.randn(24, 8)
    w = torch.randn(3, 8, 5)
    counter, flops = StepCounter(), FlopCounterMode(display=False)
    with flops, counter:
        for _ in range(k):
            y = torch.einsum("nk,km->nm", a, b)
            torch.matmul(y.expand(3, 16, 8), w)
            torch.nn.functional.linear(a, b.T, torch.zeros(8))
    want = k * (2 * 16 * 8 * 24 + 2 * 3 * 16 * 5 * 8 + 2 * 16 * 8 * 24)
    assert counter.dot_flops == want
    assert counter.raw_flops == flops.get_total_flops() == want


def test_live_bytes_rise_and_fall_with_the_storages():
    x = torch.empty(1000)                       # 4000 B -> 4096 tracked
    counter = StepCounter()
    assert counter.track([x, x[:10]]) == 4096
    with counter:
        y = x * 2                               # 4096
        z = y + 1                               # 8192
        del y                                   # 4096
        w = z.view(10, 100)                     # a view: nothing
        v = torch.cat([z, z])                   # 8000 B -> 8192
    assert counter.peak_bytes == 4096 + 4096 + 4096 + 8192 - 4096
    assert counter.live_bytes == 4096 + 4096 + 8192
    assert counter.storage_bytes([z, w, v]) == 4096 + 8192
    assert counter.storage_bytes([z, x], exclude=[x]) == 4096


@pytest.mark.parametrize("use_pallas", (None, False))
def test_a_tol_0_solve_runs_max_iter_iterations_dry(use_pallas):
    """The fused plan's loop (no runner, no capture) and the plain
    operators' host loop both run every block up to ``max_iter`` on fake
    tensors, with no host read; the op count is linear in ``max_iter``."""
    ops = {}
    with FakeTensorMode(shape_env=ShapeEnv()):
        lxi, lzt = torch.empty(12, 5), torch.empty(10, 5)
        a, b = torch.empty(12), torch.empty(10)
        geom = FactoredPositive(log_xi=lxi, log_zeta=lzt, eps=0.5)
        for max_iter in (3, 5, 7):
            counter = StepCounter()
            with counter:
                res = SK.sinkhorn_log_geometry(
                    geom, a, b, tol=0.0, max_iter=max_iter,
                    use_pallas=use_pallas)
            assert res.n_iter == max_iter
            ops[max_iter] = counter.ops
    assert ops[7] - ops[5] == ops[5] - ops[3] > 0


def test_a_stacked_tol_0_solve_runs_max_iter_iterations_dry():
    """The batched engine's lanes (``run_lane_loop`` under the stacked
    plan) run every block up to ``max_iter`` too."""
    ops = {}
    with FakeTensorMode(shape_env=ShapeEnv()):
        lxi, lzt = torch.empty(3, 12, 5), torch.empty(3, 10, 5)
        a, b = torch.empty(3, 12), torch.empty(3, 10)
        for max_iter in (3, 5, 7):
            engine = BatchedSinkhorn(eps=0.5, method="log_factored",
                                     tol=0.0, max_iter=max_iter)
            counter = StepCounter()
            with counter:
                res = engine.solve_stacked(lxi, lzt, a, b)
            assert res.n_iter.shape == (3,)
            ops[max_iter] = counter.ops
    assert ops[7] - ops[5] == ops[5] - ops[3] > 0


# ---------------------------------------------------------------------------
# Serving cells and the production cell
# ---------------------------------------------------------------------------


SERVE_CELLS = {
    "decode_dense_2x2": ("smollm_135m", ShapeSpec("d", 32, 4, "decode"),
                         (2, 2)),
    "prefill_moe_2x2": ("deepseek_v3_671b", ShapeSpec("p", 16, 4, "prefill"),
                        (2, 2)),
    "decode_one_row_2x1": ("mamba2_1p3b", ShapeSpec("l", 64, 1, "decode"),
                           (2, 1)),
}


@pytest.mark.parametrize("cell", tuple(SERVE_CELLS))
def test_serving_cells_run_dry_with_no_host_read(cell):
    arch, shape, (data, model) = SERVE_CELLS[cell]
    cfg = get_config(arch).tiny(n_experts=4) if "moe" in cell else \
        get_config(arch).tiny()
    with DR.fake_world(data * model):
        counter, mem = DR.dry_step(cfg, shape,
                                   make_local_mesh(data, model, device="cpu"))
    assert counter.dot_flops > 0 and counter.hbm_bytes > 0
    assert counter.counts.get("all-gather", 0) > 0
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == \
        mem["peak_bytes"] - mem["argument_size_in_bytes"]
    # decode writes its caches in place: those outputs alias arguments
    assert (mem["alias_size_in_bytes"] > 0) == (shape.mode == "decode")


def test_a_ranks_decode_rows_cut_the_encoder_kv_on_its_batch_dim():
    """The dry run's whisper-base decode cells found the encoder's K/V
    (each (L, B, T, H, D)) cut on L, not B, on a mesh whose data axes
    split the batch: a rank's rows cut every input on its batch dim."""
    k = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3, 8, 2, 1, 1)
    batch = {"tokens": torch.arange(8).reshape(8, 1),
             "enc_kv": {"k": k, "v": -k}}
    got = _rows(batch, 2, 4)
    assert torch.equal(got["tokens"], batch["tokens"][2:6])
    assert torch.equal(got["enc_kv"]["k"], k[:, 2:6])
    assert torch.equal(got["enc_kv"]["v"], -k[:, 2:6])


def test_run_cell_writes_the_production_cell(tmp_path):
    got = DR.run_cell("smollm_135m", "train_4k", multi_pod=False,
                      artifact_dir=str(tmp_path))
    saved = json.loads(
        (tmp_path / "smollm_135m_train_4k_pod16x16.json").read_text())
    assert saved == json.loads(json.dumps(got))
    assert saved["n_devices"] == 256 and saved["applicable"]
    for key in ("flops_per_device", "flops_per_device_raw",
                "hbm_bytes_per_device", "wire_bytes_per_device",
                "collective_counts", "collective_result_bytes", "trace_s"):
        assert key in saved
    assert saved["flops_per_device"] > 0
    assert saved["collective_counts"]["all-reduce"] > 0
    assert set(saved["roofline"]) == {"compute_s", "memory_s",
                                      "collective_s", "dominant"}
    mem = saved["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes",
                        "peak_bytes", "fits"}
    assert mem["fits"] == (mem["peak_bytes"] <= HW().hbm_bytes)
    # the rank's parameter and moment shards, not the whole tree (135M
    # float32 parameters and two moments: 1.62 GB)
    assert mem["argument_size_in_bytes"] < 135e6 * 12 / 10
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# Against the reference's compiled step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", tuple(R.CASES))
def test_rank_shards_equal_the_reference_shardings(reference, case, mesh):
    got = port_counts(case, mesh)
    ref = reference[mesh][case]
    assert got["param_bytes"] == ref["param_bytes"]
    assert got["moment_bytes"] == ref["moment_bytes"]
    print(f"{case} {mesh}: dot FLOPs a device, port / analyze_hlo "
          f"{got['flops'] / ref['flops']:.4f}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", tuple(R.CASES))
def test_dot_flops_are_within_5_percent_of_analyze_hlo(reference, case,
                                                       mesh):
    got = port_counts(case, mesh)
    ref = reference[mesh][case]
    assert abs(got["flops"] - ref["flops"]) <= FLOP_RTOL * ref["flops"]
    if case == "dense_no_ot":
        # without the OT loss the count is the reference's to the FLOP:
        # the gap of the others is the OT loss's and, on 2 x 2, MLA's
        # up-projection of every position's gathered latents (PERF.md)
        assert got["flops"] == ref["flops"]
