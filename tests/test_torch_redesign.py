"""Launch geometry of the redesigned Hopper kernels, checked on the CPU.

The persistent feature map (``feature_map._map_plan``), the one-launch
flat and paged contracts (``kermatvec._contract_plan``,
``paged._paged_plan``) and the persistent row kernel of the half-step and
matvec (``kermatvec._rows_plan``) are planned in plain Python; the CUDA
kernels trust the plan. These tests hold the plans to what the kernels
need: every grid dimension within CUDA's limits, every row covered exactly
once and in order, no more CTAs than one wave or the work, the 16-byte
path with row groups wherever B = 1 rows are 16-byte vectors, and t in
registers only where the row kernel's cap allows.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import feature_map, kermatvec, paged
from repro_torch.kernels.feature_map import _map_plan
from repro_torch.kernels.kermatvec import (
    _check_rows,
    _contract_plan,
    _flat_vectorized,
    _rows_kernel,
    _rows_plan,
    _vectorized,
)
from repro_torch.kernels.paged import _paged_plan

MAX_GRID_X = 2**31 - 1
SMS = 132                     # an H100 SXM


def _ns(upto):
    """n from 1 to ``upto``: every n up to 300, then a log-spaced sweep."""
    small = list(range(1, 301))
    big = np.unique(np.geomspace(301, upto, 60).astype(np.int64)).tolist()
    return small + big + [upto]


@pytest.mark.parametrize("r", [3, 128, 1000, 1024, 4096])
@pytest.mark.parametrize("d,blocks", [(2, 8), (8, 4), (16, 2), (64, 3),
                                      (130, 1)])
def test_feature_map_plan_covers_rows_once_within_cuda_limits(r, d, blocks):
    for n in _ns(10**7):
        p = _map_plan(n, r, d, SMS, blocks)
        assert 1 <= p.grid <= MAX_GRID_X
        assert p.grid <= max(SMS * blocks, p.col_tiles)
        assert p.row_ctas <= p.row_tiles
        assert (p.cols4 & (p.cols4 - 1)) == 0 and p.cols4 <= 32
        assert p.tile_rows <= 256 and p.reps * (256 // p.cols4) == p.tile_rows
        assert p.col_tiles * 4 * p.cols4 >= r
        assert (p.col_tiles - 1) * 4 * p.cols4 < r
        # every row tile of every column tile exactly once
        assert (p.row_tiles - 1) * p.tile_rows < n <= p.row_tiles * p.tile_rows
        if n <= 5000 or n == 10**7:
            seen = np.zeros(p.row_tiles, np.int64)
            for cta in range(0, p.grid, p.col_tiles):   # column tile 0
                seen[list(p.row_tiles_of(cta))] += 1
            assert (seen == 1).all()
            assert len(p.row_tiles_of(p.grid - 1)) >= 1


def test_feature_map_plan_is_persistent_at_the_solve_shape():
    p = _map_plan(16384, 1024, 8, SMS, 3)
    assert p.kernel == 1 and p.cols4 == 32       # anchors in registers
    assert p.col_tiles == 8 and p.grid == 8 * (SMS * 3 // 8)
    assert p.tile_rows == 32 and p.row_tiles == 512
    wide = _map_plan(16384, 1024, 130, SMS, 2)
    assert wide.kernel == 3 and wide.anchors_in_smem
    assert wide.smem == 130 * 16 * wide.cols4 <= 96 * 1024
    huge = _map_plan(100, 1024, 10**5, SMS, 8)
    assert huge.kernel == 3 and not huge.anchors_in_smem and huge.smem == 0


def test_feature_map_has_no_row_limit():
    assert not hasattr(feature_map, "_MAX_ROW_TILES")
    p = _map_plan(2_200_000, 3, 5, SMS, 8)
    assert p.row_tiles * p.tile_rows >= 2_200_000 and p.grid <= SMS * 8


def _slabs(plan, n):
    return [(max(0, b), min(n, e)) for b, e in map(plan.slab,
                                                   range(plan.splits))]


@pytest.mark.parametrize("r,B,vec,esize", [
    (1024, 1, True, 4), (256, 1, True, 4), (128, 1, True, 4), (4, 1, True, 4),
    (12, 1, True, 4), (8192, 1, True, 4), (1024, 1, True, 2), (4096, 1, True, 4),
    (256, 1, True, 2), (128, 1, True, 2), (8, 1, True, 2),
    (3, 1, False, 4), (1028, 1, False, 2), (1000, 3, False, 4),
    (40, 11, False, 4), (5000, 1, False, 4), (1, 20, False, 2),
])
def test_contract_plan_slabs_cover_rows_in_order_within_one_wave(r, B, vec,
                                                                 esize):
    blocks = 4
    for n in _ns(10**6):
        p = _contract_plan(n, r, B, vec, esize, SMS, blocks)
        slabs = _slabs(p, n)
        assert slabs[0][0] == 0 and slabs[-1][1] == n
        assert all(b < e for b, e in slabs)                 # none empty
        assert all(slabs[k][1] == slabs[k + 1][0]
                   for k in range(len(slabs) - 1))          # in order
        assert p.grid <= max(SMS * blocks, p.col_tiles * p.chunks)
        assert p.splits == 1 or p.rows_per_split >= 16      # capped by work
        assert p.splits <= max(1, n // 16) and p.splits <= 2 * SMS
        assert p.groups * p.tile <= 256
        assert p.col_tiles * p.tile * p.width >= r
        assert p.chunks * 8 >= B
        assert p.splits == 1 or p.grid <= SMS * blocks   # co-resident
        assert p.col_tiles < 65536 and p.chunks < 65536


@pytest.mark.parametrize("dtype,r", [
    (torch.float32, 4), (torch.float32, 12), (torch.float32, 128),
    (torch.float32, 256), (torch.float32, 1024), (torch.bfloat16, 8),
    (torch.bfloat16, 128), (torch.bfloat16, 256), (torch.bfloat16, 1024),
])
def test_contract_takes_16_byte_path_with_row_groups_at_every_r(dtype, r):
    xi = torch.empty((64, r), dtype=dtype)
    assert _flat_vectorized(xi, 1)
    p = _contract_plan(16384, r, 1, True, xi.element_size(), SMS, 4)
    slots = r // (16 // xi.element_size())
    assert p.vec and p.tile == min(slots, 256)
    assert p.col_tiles == -(-slots // 256)
    assert p.groups == 256 // p.tile and p.groups * p.tile <= 256
    want = min(4 * SMS // p.col_tiles, 2 * SMS)
    assert p.splits == -(-16384 // -(-16384 // want))   # e.g. 261 of 63 rows


@pytest.mark.parametrize("dtype,r,B", [
    (torch.bfloat16, 1028, 1),        # rows not on 16-byte boundaries
    (torch.float32, 3, 1),
    (torch.float32, 1024, 2),         # B > 1
    (torch.bfloat16, 256, 11),
])
def test_contract_takes_scalar_path_for_b_above_one_or_unaligned_rows(
        dtype, r, B):
    xi = torch.empty((64, r), dtype=dtype)
    assert not _flat_vectorized(xi, B)
    p = _contract_plan(16384, r, B, False, xi.element_size(), SMS, 4)
    assert not p.vec and p.width == 1 and p.chunks == -(-B // 8)
    assert p.groups * p.tile <= 256


def test_contract_refuses_vector_plan_it_cannot_run():
    with pytest.raises(ValueError):
        _contract_plan(100, 1028, 1, True, 2, SMS, 1)
    with pytest.raises(ValueError):
        _contract_plan(100, 1024, 2, True, 4, SMS, 1)


def test_unaligned_factor_takes_scalar_path():
    xi = torch.empty((64 * 1024 + 1,), dtype=torch.float32)[1:].view(64, 1024)
    assert xi.data_ptr() % 16 != 0 and not _flat_vectorized(xi, 1)


def test_contract_plan_at_trainer_shapes_is_small():
    p = _contract_plan(256, 128, 1, True, 2, SMS, 4)
    assert p.splits == 16 and p.rows_per_split == 16   # capped by the work
    p = _contract_plan(2048, 128, 1, True, 4, SMS, 4)
    assert p.splits == 128 and p.grid <= 4 * SMS
    p = _contract_plan(16384, 1024, 1, True, 4, SMS, 4)
    assert p.splits == 261 and p.grid <= 4 * SMS       # within one wave
    assert kermatvec._FLAT_THREADS == 256


def _row_cover(plan, n):
    """How often each row is taken; asserts that every warp takes its rows
    in increasing order."""
    seen = np.zeros(n, np.int64)
    for w in range(plan.grid * kermatvec._ROW_WARPS):
        rows = plan.warp_rows(w, n)
        assert rows == sorted(rows)
        seen[rows] += 1
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [40, 128, 256, 1024, 4096])
@pytest.mark.parametrize("B", [1, 3])
def test_rows_plan_covers_rows_once_in_order_within_one_wave(dtype, r, B):
    xi = torch.empty((8, r), dtype=dtype)
    vec = _vectorized(xi, B)
    es = xi.element_size()
    for blocks in (1, 3, 8):
        for n in (1, 7, 256, 2048, 16384):
            p = _rows_plan(n, r, B, vec, es, SMS, blocks)
            assert 1 <= p.grid <= min(SMS * blocks, MAX_GRID_X)
            assert (_row_cover(p, n) == 1).all()
            # no CTA without a row
            last = (p.grid - 1) * kermatvec._ROW_WARPS
            assert any(p.warp_rows(w, n)
                       for w in range(last, last + kermatvec._ROW_WARPS))
            if p.nv:
                assert p.rows * p.nv == 8 and p.smem == 0
                # every batch of R rows starts on a multiple of R
                assert all(rows[0] % p.rows == 0 for rows in (
                    p.warp_rows(w, n)
                    for w in range(p.grid * kermatvec._ROW_WARPS)) if rows)
            else:
                assert p.rows == 1 and p.smem == 4 * r * B


@pytest.mark.parametrize("dtype,r,nv,rows", [
    (torch.float32, 40, 1, 8), (torch.float32, 128, 1, 8),
    (torch.float32, 256, 2, 4), (torch.float32, 512, 4, 2),
    (torch.float32, 500, 4, 2), (torch.bfloat16, 1000, 4, 2),
    (torch.bfloat16, 40, 1, 8), (torch.bfloat16, 256, 1, 8),
    (torch.bfloat16, 512, 2, 4), (torch.bfloat16, 1024, 4, 2),
])
def test_rows_take_registers_where_the_cap_allows(dtype, r, nv, rows):
    xi = torch.empty((16, r), dtype=dtype)
    assert _vectorized(xi, 1)
    got = _rows_kernel(r, 1, True, xi.element_size())
    assert got == (nv, rows, 0)
    width = 16 // xi.element_size()
    assert nv <= kermatvec._MAX_T_VECTORS == 4  # a batch of >= 2 rows
    assert 32 * nv >= r // width                # every vector of a row


def test_rows_plan_at_the_solve_shape_keeps_four_rows_in_flight():
    p = _rows_plan(16384, 256, 1, True, 4, SMS, 8)
    assert (p.nv, p.rows) == (2, 4) and p.grid == 512   # a batch a warp
    p = _rows_plan(16384, 1024, 1, True, 4, SMS, 3)         # t in smem
    assert (p.nv, p.rows) == (0, 1) and p.grid == 2 * SMS   # 8 rounds, not 6
    assert {len(p.warp_rows(w, 16384)) for w in range(p.grid * 8)} == {7, 8}
    assert p.warp_rows(0, 16384)[:2] == [0, p.grid * 8]    # a band of rows
    p = _rows_plan(16384, 1024, 1, True, 2, SMS, 3)         # bf16
    assert (p.nv, p.rows) == (4, 2) and p.grid == 2 * SMS   # 4 rounds, not 3


def test_rows_plan_leaves_the_fewest_batch_slots_idle():
    for n in (1, 7, 1000, 4096, 16384, 10**6):
        for blocks in (1, 2, 3, 5, 8):
            p = _rows_plan(n, 1024, 1, True, 4, SMS, blocks)
            batches = -(-n // p.rows)
            warps = p.grid * kermatvec._ROW_WARPS
            idle = -(-batches // warps) * warps - batches
            for b in range(1, blocks + 1):
                w = min(SMS * b, -(-batches // 8)) * 8
                assert idle <= -(-batches // w) * w - batches


@pytest.mark.parametrize("dtype,r,B", [
    (torch.float32, 1024, 1), (torch.float32, 1000, 1),     # past the cap
    (torch.float32, 2048, 1), (torch.float32, 4096, 1),
    (torch.bfloat16, 2048, 1), (torch.bfloat16, 4096, 1),
    (torch.float32, 256, 3), (torch.bfloat16, 1024, 2),     # B > 1
    (torch.float32, 1001, 1), (torch.bfloat16, 1028, 1),    # unaligned rows
    (torch.float32, 3, 1),
])
def test_rows_keep_t_in_shared_memory_past_the_cap_for_b_above_one_and_unaligned_rows(
        dtype, r, B):
    xi = torch.empty((16, r), dtype=dtype)
    vec = _vectorized(xi, B)
    assert _rows_kernel(r, B, vec, xi.element_size()) == (0, 1, 4 * r * B)


def test_rows_refuse_a_vector_plan_they_cannot_run():
    with pytest.raises(ValueError):
        _rows_kernel(1028, 1, True, 2)
    with pytest.raises(ValueError):
        _rows_kernel(256, 3, True, 4)


@pytest.mark.parametrize("r,B", [(1, 1), (40, 11), (256, 3), (1024, 8),
                                 (4096, 14), (58112, 1), (227 * 256, 1),
                                 (1, 58112)])
def test_rows_still_admit_every_shape_whose_t_fits_a_cta(r, B):
    """The rows' admission is unchanged: any n, r, B >= 1 with r * B * 4
    <= 227 KiB of t, whichever path the planner takes."""
    xi, t = torch.empty((3, r)), torch.empty((r, B))
    _check_rows(xi, t, "rows")
    p = _rows_plan(3, r, B, _vectorized(xi, B), 4, SMS, 1)
    assert p.smem <= 227 * 1024 and p.grid == 1
    with pytest.raises(ValueError):
        _check_rows(torch.empty((3, r + 1)), torch.empty((r + 1, 58112 // r
                                                          + 1)), "rows")


@pytest.mark.parametrize("n_pages,ps,r,B,dtype", [
    (512, 64, 1024, 1, torch.float32), (512, 64, 256, 1, torch.float32),
    (512, 64, 1024, 1, torch.bfloat16), (8192, 64, 1024, 1, torch.float32),
    (8, 128, 64, 3, torch.float32), (1, 8, 40, 11, torch.float32),
    (128, 8, 1032, 1, torch.bfloat16),
])
def test_paged_plan_is_the_flat_geometry_within_one_wave(n_pages, ps, r, B,
                                                         dtype):
    xi = torch.empty((8, r), dtype=dtype)
    vec = _flat_vectorized(xi, B)
    for blocks in (1, 2, 4):
        p = _paged_plan(n_pages, ps, r, B, vec, xi.element_size(), SMS,
                        blocks)
        flat = _contract_plan(n_pages * ps, r, B, vec, xi.element_size(),
                              SMS, blocks)
        assert p._replace(splits=flat.splits,
                          rows_per_split=flat.rows_per_split) == flat
        assert 1 <= p.splits <= min(n_pages, flat.splits)
        assert p.splits == 1 or p.grid <= SMS * blocks      # co-resident
        assert p.rows_per_split == 0        # the kernel splits live rows


def test_paged_plan_fills_a_cta_with_row_groups_at_r_256():
    p = _paged_plan(512, 64, 256, 1, True, 4, SMS, 2)
    assert p.vec and p.tile == 64 and p.groups == 4
    assert p.groups * p.tile == kermatvec._FLAT_THREADS
    assert p.splits == 263 and p.grid <= 2 * SMS            # one wave
    assert not hasattr(paged, "_split_pages")
