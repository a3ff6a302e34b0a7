"""The rules the port keeps: no JAX and nothing of ``repro`` inside it, the
card by default with no silent CPU fallback, a fused plan for every
factored kind in both modes, and every method of ``solve`` ported."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import (
    METHODS,
    PORTED_METHODS,
    ArcCosineFeatureMap,
    GridSeparable,
    OTProblem,
    sinkhorn_divergence_geometry,
    solve,
)
from repro_torch.kernels import backend, build
from repro_torch.kernels.ops import geometry_ops, observe_plan_selection
from repro_torch.streaming import PagedFeatureStore, StreamingDistribution

sys.path.insert(0, str(Path(__file__).resolve().parent))

PKG = Path(repro_torch.__file__).resolve().parent
SOURCES = sorted(PKG.rglob("*.py"))


def _module_name(path):
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module_name(p) for p in SOURCES)


def _cloud_arrays(n=12, m=10, d=2, r=5):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 13
    # the families slice's modules are among those imported and checked
    assert {"repro_torch.core.accelerated", "repro_torch.core.barycenter",
            "repro_torch.core.nystrom",
            "repro_torch.examples.sphere_barycenter"} <= set(MODULES)
    # so are the serving slice's
    assert {"repro_torch.serving.service", "repro_torch.serving.runner_cache",
            "repro_torch.serving.warmstart", "repro_torch.serving.traffic",
            "repro_torch.resilience.ladder", "repro_torch.resilience.chaos",
            "repro_torch.launch.ot_service"} <= set(MODULES)
    # and the tuner's and the sharded solves'
    assert {"repro_torch.kernels.autotune", "repro_torch.distributed",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.core.sharded"} <= set(MODULES)
    # and the LM slice's: models, optimizer, checkpoints, supervisor, data,
    # configs, drivers and the example
    assert {"repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.ot_loss",
            "repro_torch.models.model", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.manager",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.data.pipeline", "repro_torch.configs.base",
            "repro_torch.configs.smollm_135m", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.launch.specs",
            "repro_torch.examples.train_lm"} <= set(MODULES)
    # and the MoE slice's: the Sinkhorn router and the MoE layer
    assert {"repro_torch.core.routing", "repro_torch.models.moe"} <= \
        set(MODULES)
    # and the SSM slice's Mamba2 mixer
    assert "repro_torch.models.ssm" in MODULES
    # and the encoder-decoder slice's config (its cross-attention lives in
    # repro_torch.models.attention)
    assert "repro_torch.configs.whisper_base" in MODULES
    # and the multi-card slice's: the int8 gradient compression (the
    # logical axes, expert and context parallelism live in the modules of
    # distributed.sharding, models.moe, models.ssm and launch.specs)
    assert "repro_torch.optim.compression" in MODULES
    from repro_torch.distributed import MeshContext, use_mesh_context
    from repro_torch.models.moe import moe_ep_local
    from repro_torch.optim import compressed_psum
    assert callable(moe_ep_local) and callable(compressed_psum)
    assert MeshContext and use_mesh_context


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_without_cuda_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, u = _cloud_arrays()
    with pytest.raises(RuntimeError, match="CUDA"):
        OTProblem.from_point_clouds(x, y, u, eps=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.gaussian_point_cloud(x, y, u, eps=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device()
    axes = [np.linspace(0.0, 1.0, 4)] * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        GridSeparable.build(axes, eps=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        OTProblem.from_grid(axes, eps=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ArcCosineFeatureMap(r=4, d=2).init(torch.Generator().manual_seed(0))
    assert backend.resolve_device("cpu") == torch.device("cpu")
    prob = OTProblem.from_point_clouds(x, y, u, eps=0.5, device="cpu")
    assert prob.a.device.type == "cpu"


def test_streaming_stores_default_to_the_card_and_raise_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedFeatureStore(4, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDistribution.from_features(
            [0], np.ones((1, 4), np.float32), np.ones(1, np.float32),
            eps=0.5)
    store = PagedFeatureStore(4, 64, device="cpu")
    store.add([0], np.ones((1, 4), np.float32), np.ones(1, np.float32))
    assert store.device_features().device.type == "cpu"


def test_ot_service_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    from repro_torch.serving import OTService, make_traffic
    from repro_torch.serving.traffic import TrafficSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OTService(eps=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_traffic(TrafficSpec(n_requests=2, pool_size=2))
    svc = OTService(eps=0.5, device="cpu")
    assert svc.device == torch.device("cpu")


def test_unsupported_device_is_refused():
    x, y, u = _cloud_arrays()
    geom = convert.gaussian_point_cloud(x, y, u, eps=0.5, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        OTProblem.from_geometry(geom, device="meta")


def _geometries():
    x, y, u = _cloud_arrays()
    rng = np.random.default_rng(1)
    lxi = rng.standard_normal((12, 5)).astype(np.float32)
    lzt = rng.standard_normal((10, 5)).astype(np.float32)
    return {
        "gaussian": convert.gaussian_point_cloud(x, y, u, eps=0.5,
                                                 device="cpu"),
        "factored": convert.factored_positive(xi=np.exp(lxi),
                                              zeta=np.exp(lzt), eps=0.5,
                                              device="cpu"),
        "log_factored": convert.factored_positive(log_xi=lxi, log_zeta=lzt,
                                                  eps=0.5, device="cpu"),
    }


@pytest.mark.parametrize("kind", ["gaussian", "factored", "log_factored"])
def test_scaling_plan_is_built_for_every_kind(kind):
    """The scaling plan is built for every kind (it no longer raises): its
    factors are the positive features, the log plan's their logs."""
    geom = _geometries()[kind]
    plan = geometry_ops(geom, mode="scaling")
    log_plan = geometry_ops(geom, mode="log")
    assert (plan.mode, plan.kind) == ("scaling", kind)
    assert (log_plan.mode, log_plan.kind) == ("log", kind)
    for w, lw in zip(plan.features, log_plan.features):
        assert torch.all(w > 0)
        torch.testing.assert_close(torch.log(w), lw, rtol=1e-5, atol=1e-5)


def test_factored_method_takes_the_fused_scaling_plan():
    """``solve`` on linear features selects the fused scaling plan (it no
    longer needs ``use_pallas=False``) and agrees with the plain
    operators."""
    prob = convert.ot_problem(_geometries()["factored"], device="cpu")
    with observe_plan_selection() as events:
        fused = solve(prob)
    assert events == [{"geometry": "FactoredPositive", "mode": "scaling",
                       "kind": "factored", "precision": "highest"}]
    plain = solve(prob, use_pallas=False)
    assert fused.n_iter == plain.n_iter
    assert float(fused.cost) == pytest.approx(float(plain.cost), rel=1e-5)
    torch.testing.assert_close(fused.u, plain.u, rtol=1e-5, atol=1e-6)


def test_unknown_precision_is_a_value_error():
    prob = convert.ot_problem(_geometries()["gaussian"], device="cpu")
    with pytest.raises(ValueError):
        solve(prob, precision="fp8")


def test_requires_grad_input_raises_not_implemented():
    """A solve refuses inputs that require grad (no backprop through the
    loop); the divergence differentiates them through the envelope VJP."""
    x, y, u = _cloud_arrays()
    xt = torch.as_tensor(x).requires_grad_(True)
    geom = repro_torch.core.GaussianPointCloud.build(
        xt, torch.as_tensor(y), torch.as_tensor(u), eps=0.5)
    (grad,) = torch.autograd.grad(sinkhorn_divergence_geometry(geom), [xt])
    assert grad.shape == xt.shape and torch.isfinite(grad).all()
    assert float(grad.abs().max()) > 0
    prob = convert.ot_problem(_geometries()["gaussian"], device="cpu")
    with pytest.raises(NotImplementedError, match="gradients"):
        solve(OTProblem(prob.geometry, prob.a.clone().requires_grad_(True),
                        prob.b))


@pytest.mark.parametrize("method", ["sharded", "sharded_log"])
def test_unported_methods_raise_not_implemented(method, tmp_path):
    """The sharded methods run: a small sharded solve in a gloo world of
    this process alone matches the single-device solve of the same mode,
    and no method of ``solve`` raises ``NotImplementedError`` any more
    (without a mesh they refuse with the JAX package's ``ValueError``)."""
    import torch_sharded_worker as W
    prob = convert.ot_problem(_geometries()["gaussian"], device="cpu")
    assert set(PORTED_METHODS) == set(METHODS)
    with pytest.raises(ValueError, match="requires a mesh"):
        solve(prob, method=method)
    with W.world_of_one(tmp_path / "init") as mesh:
        res = solve(prob, method=method, mesh=mesh)
    local = solve(prob, method="factored" if method == "sharded"
                  else "log_factored")
    assert abs(res.n_iter - local.n_iter) <= 1
    assert float(res.cost) == pytest.approx(float(local.cost), rel=1e-5)
    torch.testing.assert_close(res.f, local.f, rtol=0, atol=1e-5)


def test_build_imports_without_nvcc_and_refuses_to_build(monkeypatch,
                                                         tmp_path):
    code = "import repro_torch.kernels.build as b; print(b.BUILD_DIR.name)"
    env = dict(os.environ, PYTHONPATH=str(PKG.parent), PATH="/nonexistent")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "repro_torch", \
        out.stderr
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_cuda_sources_hold_one_kernel_per_ported_function():
    csrc = PKG / "kernels" / "csrc"
    fm = (csrc / "feature_map.cu").read_text()
    lm = (csrc / "logmatvec.cu").read_text()
    km = (csrc / "kermatvec.cu").read_text()
    fl = (csrc / "fused_loop.cu").read_text()
    ops = (csrc / "feature_ops.cuh").read_text()   # shared by km and pg
    assert "__global__" not in ops and "__fdiv_rn" in ops
    assert '#include "feature_ops.cuh"' in km
    assert "__global__" in fm and "gaussian_feature_map_launch" in fm
    for name in ("cp.async", "__stcs", "gaussian_feature_map_occupancy",
                 "cudaOccupancyMaxActiveBlocksPerMultiprocessor"):
        assert name in fm
    for name in ("log_contract_kernel", "log_grid_combine",
                 "log_feature_contract_occupancy", "log_halfstep_kernel",
                 "log_feature_contract_launch", "log_halfstep_launch",
                 "__nv_bfloat16", '#include "feature_ops.cuh"'):
        assert name in lm
    # the log half-step is the row kernel's persistent grid, sized by an
    # occupancy query, each row an exact two-pass LSE without the online
    # push (which has no user left)
    assert "log_halfstep_occupancy" in lm
    assert lm.count("cudaOccupancyMaxActiveBlocksPerMultiprocessor") >= 2
    assert "lse_push" not in lm
    assert "lse_push" not in (csrc / "common.cuh").read_text()
    # the log contract is one cooperative launch: its (max, sum) partials
    # meet at a grid barrier, no second (combine) kernel
    assert "log_contract_combine_kernel" not in lm
    assert "log_contract_partial_kernel" not in lm
    assert "cudaLaunchCooperativeKernel" in lm and "this_grid().sync()" in lm
    for name in ("flat_contract_kernel", "grid_combine",
                 "feature_contract_occupancy",
                 "feature_rows_kernel",
                 "feature_contract_launch", "sinkhorn_halfstep_launch",
                 "feature_matvec_launch", "__nv_bfloat16"):
        assert name in km
    assert "feature_contract_combine_kernel" not in km     # one launch
    # the row kernel is a persistent grid sized by an occupancy query
    assert "feature_rows_occupancy" in km
    assert km.count("cudaOccupancyMaxActiveBlocksPerMultiprocessor") >= 2
    for name in ("ContractArgs", "flat_accumulate", "grid_combine",
                 "contract_partial"):
        assert name in ops                 # shared by the two contracts
    for name in ("__global__", "log_sinkhorn_block_kernel",
                 "log_sinkhorn_block_launch", "sinkhorn_block_kernel",
                 "sinkhorn_block_launch", "__nv_bfloat16",
                 "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert name in fl
    # the log megakernel is one thread block cluster whose CTAs meet over
    # distributed shared memory, placed only where the card can place it
    for name in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "map_shared_rank", "cluster.sync()",
                 "cudaOccupancyMaxActiveClusters",
                 "log_sinkhorn_block_clusters"):
        assert name in fl
    # so is the scaling megakernel, placed by its own query: both kernels
    # read the cluster, combine over distributed shared memory (a column
    # pass and the block-end error each), and no kernel is one CTA alone
    scaling = fl[fl.index("sinkhorn_block_kernel(const ScalingArgs"):]
    scaling = scaling[:scaling.index("\n}\n")]
    assert "cg::this_cluster()" in scaling and "cluster.sync()" in scaling
    assert "sinkhorn_block_clusters" in fl and "sum_cluster_combine" in fl
    assert fl.count("cg::this_cluster()") == 2
    assert fl.count("map_shared_rank") >= 4
    assert "<<<1," not in fl
    pg = (csrc / "paged.cu").read_text()
    for name in ("paged_contract_kernel", "paged_rows_kernel",
                 "paged_feature_contract_launch",
                 "paged_feature_contract_occupancy", "paged_halfstep_launch",
                 "paged_feature_matvec_launch", "page_live", "grid_combine",
                 '#include "feature_ops.cuh"', "__nv_bfloat16"):
        assert name in pg
    # the paged contract is one cooperative launch: its partials meet at a
    # grid barrier, no second (combine) kernel
    assert "paged_contract_combine_kernel" not in pg
    assert "cudaLaunchCooperativeKernel" in pg and "this_grid().sync()" in pg
    for name in ("log_matvec_kernel", "log_matvec_launch"):
        assert name in lm
    assert lm.count("__global__") == 3          # contract, half-step, row LSE
    assert set(build.SOURCES) == {"feature_map", "logmatvec", "kermatvec",
                                  "fused_loop", "paged"}
    # the flat contract's partials meet at a grid barrier of a cooperative
    # launch, which the runtime refuses rather than hang
    assert "cudaLaunchCooperativeKernel" in km and "this_grid().sync()" in km
    for src in (fm, lm, km, fl, pg, ops):
        assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
        assert not re.search(r"\b(?:atom|red)\.[\w.]+", src)
        for lib in ("cublas", "cudnn", "cutlass", "wmma", "mma.sync"):
            assert lib not in src.lower()


def _graph_path_functions():
    """What a runner captures: the block-and-commit body, the plans' step
    factories and their steps (``make_step`` / ``make_block_step`` and the
    ``step`` closures of ``kernels/ops.py``)."""
    for path, names in (
            (PKG / "core" / "sinkhorn.py", {"run_check_blocks"}),
            (PKG / "kernels" / "ops.py", {"make_step", "make_block_step",
                                          "step", "init"})):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in names:
                yield f"{path.name}:{node.name}:{node.lineno}", node


def test_graph_path_reads_nothing_to_the_host():
    """No ``float(err)``, ``.item()`` or other read of a tensor to the
    host inside the loop a runner captures in a CUDA graph: the loop
    reads the committed state once a replay, outside it."""
    found = list(_graph_path_functions())
    assert {name.split(":")[1] for name, _ in found} == {
        "run_check_blocks", "make_step", "make_block_step", "step", "init"}
    reads = []
    for name, fn in found:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("float", "int", "bool"):
                reads.append(f"{name}: {f.id}()")
            if isinstance(f, ast.Attribute) and f.attr in (
                    "item", "tolist", "cpu", "numpy", "synchronize"):
                reads.append(f"{name}: .{f.attr}()")
    assert not reads, reads
    # the graph path's host loop reads the state only through
    # _read_status, once a replay (run_marginal_loop is the plain
    # operators' host loop, one float(err) a block)
    body = (PKG / "core" / "sinkhorn.py").read_text()
    loop = body[body.index("def _run_captured("):]
    loop = loop[:loop.index("\n\n\n")]
    assert "float(" not in loop and ".item()" not in loop
    assert ".tolist()" not in loop and loop.count("_read_status(state)") == 1
