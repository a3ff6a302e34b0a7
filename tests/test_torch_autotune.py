"""The port's launch-geometry autotuner (``repro_torch.kernels.autotune``),
on the CPU.

Mirrors the JAX package's tuner tests where they apply
(``tests/test_autotune.py``): the static plan is each planner's own
answer, bit for bit, over a grid of shapes; candidates start with it, stay
within 8 and never need more than one wave of CTAs where the kernel meets
at a grid barrier; pinned knobs win; a warm cache times nothing; corrupt,
stale and unwritable caches do not break a resolve; the scope and the
environment variables work; the card's name, SM count and capability are
in the key; a resolve that would time under a CUDA-graph capture raises.
The card is not here, so the timing path runs with a fake runner, a fake
clock and a fake card, each patched in.
"""
import itertools
import json

import pytest
import torch

from repro_torch.kernels import (
    autotune,
    feature_map,
    fused_loop,
    kermatvec,
    logmatvec,
    paged,
)
from repro_torch.kernels.build import KernelError

CUDA = torch.device("cuda", 0)


def _contract_grid():
    for P, n, r, B, es, bps in itertools.product(
            (1, 4, 32, 300), (7, 1001, 16384), (12, 256, 1024), (1, 3, 11),
            (2, 4), (1, 8)):
        for vec in ((0, 1) if B == 1 and r % (16 // es) == 0 else (0,)):
            yield dict(P=P, n=n, r=r, B=B, vec=vec, esize=es, sms=132,
                       bps=bps)


def _rows_grid():
    for ext in _contract_grid():
        for divide in (0, 1):
            yield dict(ext, divide=divide, bps=min(ext["bps"], 3))


def _halfstep_grid():
    for ext in _contract_grid():
        ext = dict(ext, m=ext.pop("n"))
        if ext["B"] <= logmatvec.MAX_COLS:
            yield dict(ext, bps=min(ext["bps"], 3))


def _map_grid():
    for n, r, d, bps in itertools.product((1, 100, 4097, 16384, 2_200_000),
                                          (3, 128, 1024), (2, 8, 64, 130),
                                          (1, 2, 4)):
        yield dict(n=n, r=r, d=d, sms=132, bps=bps)


def _paged_grid():
    for pages, size, r, B, es, bps in itertools.product(
            (1, 16, 512), (8, 64), (12, 1024), (1, 3), (2, 4), (1, 8)):
        for vec in ((0, 1) if B == 1 and r % (16 // es) == 0 else (0,)):
            yield dict(pages=pages, page_size=size, r=r, B=B, vec=vec,
                       esize=es, sms=132, bps=bps)


def _block_grid():
    for n, m, r, es in itertools.product((1, 3, 37, 176, 256, 352),
                                         (3, 53, 176, 256), (13, 128, 1100),
                                         (2, 4)):
        dtype = torch.bfloat16 if es == 2 else torch.float32
        if fused_loop.block_plan_fits(n, m, r, 1, dtype):
            yield dict(n=n, m=m, r=r, esize=es)


def _block_of(mode):
    def plan_of(ext, cluster=0):
        return fused_loop._block_plan(ext["n"], ext["m"], ext["r"],
                                      fused_loop._ext_dtype(ext), mode,
                                      cluster=cluster)
    return plan_of


# kernel -> (extents grid, planner at given knobs, the knob, the barrier's
# CTAs of a plan or None)
KERNELS = {
    "feature_map": (_map_grid, lambda e, k=0: feature_map._map_of(e, k),
                    "row_ctas", None),
    "feature_contract": (_contract_grid, kermatvec._contract_of, "splits",
                         lambda e, p: e["P"] * p.grid),
    "feature_rows": (_rows_grid, kermatvec._rows_of, "per_sm", None),
    "log_contract": (_contract_grid, logmatvec._contract_of, "splits",
                     lambda e, p: e["P"] * p.grid),
    "log_halfstep": (_halfstep_grid, logmatvec._halfstep_of, "per_sm", None),
    "paged_contract": (_paged_grid, paged._paged_of, "splits",
                       lambda e, p: p.grid),
    "sinkhorn_block": (_block_grid, _block_of("scaling"), "cluster", None),
    "log_sinkhorn_block": (_block_grid, _block_of("log"), "cluster", None),
}


@pytest.fixture(autouse=True)
def fresh_tuner():
    runners = dict(autotune._RUNNERS)
    autotune.configure(_reset=True)
    autotune.clear_cache()
    autotune.reset_stats()
    yield
    autotune._RUNNERS.clear()
    autotune._RUNNERS.update(runners)
    autotune.configure(_reset=True)
    autotune.clear_cache()
    autotune.reset_stats()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_static_plan_is_the_planners_plan(kernel):
    grid, plan_of, knob, _ = KERNELS[kernel]
    seen = 0
    for ext in grid():
        static = autotune.static_plan(kernel, ext)
        assert set(static) == {knob}
        assert plan_of(ext, static[knob]) == plan_of(ext), ext
        seen += 1
    assert seen >= 20


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_candidates_start_static_and_fit_a_wave_at_a_barrier(kernel):
    grid, plan_of, knob, barrier_ctas = KERNELS[kernel]
    several = 0
    for ext in grid():
        cands = autotune.candidates(kernel, ext)
        assert cands[0] == autotune.static_plan(kernel, ext)
        assert 1 <= len(cands) <= autotune.MAX_CANDIDATES
        assert len({c[knob] for c in cands}) == len(cands)
        several += len(cands) > 1
        for c in cands:
            plan = plan_of(ext, c[knob])
            assert getattr(plan, knob if knob != "per_sm" else "grid") >= 1
            if barrier_ctas is not None and plan.splits > 1:
                assert barrier_ctas(ext, plan) <= ext["sms"] * ext["bps"]
            if kernel.endswith("sinkhorn_block"):
                assert fused_loop._runs(plan)
    assert several


def test_deterministic_default_returns_the_static_plan():
    ext = dict(P=1, n=16384, r=1024, B=1, vec=1, esize=4, sms=132, bps=8)
    want = autotune.static_plan("feature_contract", ext)
    assert not autotune.tuning_enabled()
    # a CUDA device, tuning off: no key, no timing, no file
    assert autotune.resolve("feature_contract", ext, torch.float32,
                            CUDA) == want
    assert autotune.resolve("feature_contract", ext, torch.float32, CUDA,
                            deterministic=True) == want
    stats = autotune.stats()
    assert stats["trials"] == 0 and stats["static"] == 2


def test_cpu_resolve_is_static_even_with_tuning_on(tmp_path):
    ext = dict(n=16384, r=1024, d=8, sms=132, bps=2)
    with autotune.tuning(cache_path=str(tmp_path / "t.json")):
        got = autotune.resolve("feature_map", ext, torch.float32,
                               torch.device("cpu"))
    assert got == autotune.static_plan("feature_map", ext)
    assert autotune.stats()["static"] == 1
    assert autotune.stats()["trials"] == 0
    assert not (tmp_path / "t.json").exists()


def test_pinned_knobs_win():
    ext = dict(P=32, n=1024, r=256, B=1, vec=1, esize=4, sms=132, bps=8)
    with autotune.pinned("feature_contract", splits=1):
        assert autotune.resolve("feature_contract", ext) == {"splits": 1}
    assert autotune.resolve("feature_contract", ext) == \
        autotune.static_plan("feature_contract", ext)
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.static_plan("no_such_kernel", ext)


# ---------------------------------------------------------------------------
# The timing path, with a fake card, clock and runner
# ---------------------------------------------------------------------------

_EXT = dict(P=32, n=1024, r=256, B=1, vec=1, esize=4, sms=132, bps=8)
CARD = "NVIDIA H100 80GB HBM3/sm132/cc9.0"


@pytest.fixture
def fake_card(monkeypatch):
    """A card named ``CARD``; a runner that records its launches; a clock
    on which one slab is fastest."""
    launched = []

    def factory(ext, dtype, device):
        return lambda knobs: launched.append(dict(knobs))

    monkeypatch.setattr(autotune, "card_key", lambda device: CARD)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(autotune, "_time_us",
                        lambda run, knobs, device: (run(knobs),
                                                    knobs["splits"])[1])
    autotune.register_runner("feature_contract", factory)
    return launched


def _tune_once():
    return autotune.resolve("feature_contract", _EXT, torch.float32, CUDA,
                            deterministic=False)


def test_cache_round_trip_makes_zero_trials_on_a_warm_cache(fake_card,
                                                            tmp_path):
    path = tmp_path / "cache" / "tuning.json"
    autotune.configure(cache_path=str(path), deterministic=False)
    plan = _tune_once()
    assert plan == {"splits": 1}
    first = autotune.stats()
    assert first["trials"] == len(autotune.candidates("feature_contract",
                                                      _EXT))
    assert first["keys_tuned"] == 1 and len(fake_card) == first["trials"]
    payload = json.loads(path.read_text())
    assert payload["version"] == autotune.CACHE_VERSION
    (key, entry), = payload["entries"].items()
    assert entry["knobs"] == plan and CARD in key
    autotune.reset_stats()
    assert _tune_once() == plan                       # memory
    assert autotune.stats()["memory_hits"] == 1
    autotune.clear_cache()                            # a fresh process
    autotune.reset_stats()
    del fake_card[:]
    assert _tune_once() == plan
    stats = autotune.stats()
    assert stats["trials"] == 0 and stats["keys_tuned"] == 0
    assert stats["disk_hits"] == 1 and not fake_card


@pytest.mark.parametrize("payload", [
    "{ not json",
    json.dumps({"version": 999, "entries": {"k": {"knobs": {"splits": 1}}}}),
    json.dumps({"entries": "nope"}),
    json.dumps([1, 2, 3]),
    json.dumps({"version": 1, "entries": {"k": {"knobs": {"splits": "a"}}}}),
])
def test_corrupt_or_stale_cache_is_ignored_and_rewritten(fake_card, tmp_path,
                                                         payload):
    path = tmp_path / "tuning.json"
    path.write_text(payload)
    autotune.configure(cache_path=str(path), deterministic=False)
    plan = _tune_once()
    assert autotune.stats()["keys_tuned"] == 1
    fresh = json.loads(path.read_text())
    assert fresh["version"] == autotune.CACHE_VERSION
    assert [e["knobs"] for e in fresh["entries"].values()] == [plan]


def test_unwritable_cache_keeps_the_in_process_winner(fake_card, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    autotune.configure(cache_path=str(blocker / "tuning.json"),
                       deterministic=False)
    plan = _tune_once()
    autotune.reset_stats()
    assert _tune_once() == plan
    assert autotune.stats()["memory_hits"] == 1


def test_tuning_scope_and_environment(fake_card, monkeypatch, tmp_path):
    assert not autotune.tuning_enabled()
    monkeypatch.setenv(autotune.TUNE_ENV, "1")
    assert autotune.tuning_enabled()
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "env.json"))
    assert autotune.cache_path() == str(tmp_path / "env.json")
    assert autotune.resolve("feature_contract", _EXT, torch.float32,
                            CUDA) == {"splits": 1}
    assert (tmp_path / "env.json").exists()
    monkeypatch.delenv(autotune.TUNE_ENV)
    monkeypatch.delenv(autotune.CACHE_ENV)
    assert autotune.cache_path().endswith(".cache/repro_torch/tuning.json")
    with autotune.tuning(cache_path=str(tmp_path / "scoped.json")):
        assert autotune.tuning_enabled()
        autotune.clear_cache()
        _tune_once()
    assert (tmp_path / "scoped.json").exists()
    assert not autotune.tuning_enabled()


def test_key_holds_the_card_and_another_card_retimes(fake_card, monkeypatch,
                                                     tmp_path):
    props = type("P", (), dict(multi_processor_count=132, major=9, minor=0))
    monkeypatch.undo()      # the real card_key, on faked device queries
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device: "NVIDIA H100 80GB HBM3")
    key = autotune._key("feature_contract", _EXT, torch.bfloat16, CUDA)
    assert CARD in key and "dtype=bfloat16" in key and "vec=1" in key
    assert key.endswith(f"v{autotune.CACHE_VERSION}")
    for name in ("P", "n", "r", "B", "esize", "sms", "bps"):
        assert f"{name}={_EXT[name]}" in key
    # an entry written for another card does not serve this one
    monkeypatch.setattr(autotune, "card_key", lambda device: "other/sm1/cc1.0")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(autotune, "_time_us",
                        lambda run, knobs, device: knobs["splits"])
    autotune.register_runner("feature_contract",
                             lambda e, d, dev: (lambda knobs: None))
    autotune.configure(cache_path=str(tmp_path / "t.json"),
                       deterministic=False)
    _tune_once()
    monkeypatch.setattr(autotune, "card_key", lambda device: CARD)
    autotune.clear_cache()
    autotune.reset_stats()
    _tune_once()
    assert autotune.stats()["keys_tuned"] == 1
    assert len(json.loads((tmp_path / "t.json").read_text())["entries"]) == 2


def test_resolve_that_would_time_under_capture_raises(fake_card, monkeypatch,
                                                      tmp_path):
    autotune.configure(cache_path=str(tmp_path / "t.json"),
                       deterministic=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(KernelError, match="captured"):
        _tune_once()
    assert not fake_card
    # a plan fixed before the capture is served under it
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    plan = _tune_once()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert _tune_once() == plan
