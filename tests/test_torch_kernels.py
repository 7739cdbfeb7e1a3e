"""The kernels' launch-shape choice on the CPU, with no card and no CUDA
toolkit: ``_kernels._pick_rows`` (K1, K5), K3's tile (``guided_wta_tile``)
and K4's tile height (``guided_wta_dual_tile_rows``), and the steps and
bands of K1 and K5 on synthetic shared-memory tables.
tests/test_torch_cuda.py checks the picks with the real shared-memory
functions on a card."""

import inspect

import pytest

from stereo_matching_cuda_tpu_torch.ops import _kernels

from _torch_threads import _one_torch_thread  # noqa: F401

N_SM = 132            # an H100 SXM's SMs
SMALL, BIG = (288, 384), (1992, 3008)


# {(radius, size_d): {(columns, rows): bytes}}: K3's shared memory,
# rounded, where every tile fits one block (R=1), the 64x64 tile fits up to
# 64 disparities and 64x56 at 128 (R=9), no 64-column tile fits and only 16
# and 8 rows of 32 columns fit (R=20), only 8 rows (R=23), none (R=40); and
# two made-up radii: 98, where of the 64-column tiles only 64x48 fits, and
# 99, where none does and the 32-row tile fits one CTA per SM and the
# others two.
K3_SMEM = {(1, 1): {(64, 64): 118_000, (64, 56): 104_000, (64, 48): 90_000,
                    (32, 32): 33_000, (32, 16): 18_000, (32, 8): 11_000},
           (9, 16): {(64, 64): 223_000, (64, 56): 204_000, (64, 48): 185_000,
                     (32, 32): 96_000, (32, 16): 72_000, (32, 8): 60_000},
           (9, 64): {(64, 64): 228_000, (64, 56): 209_000, (64, 48): 189_000,
                     (32, 32): 99_000, (32, 16): 74_000, (32, 8): 62_000},
           (9, 128): {(64, 64): 234_000, (64, 56): 214_000, (64, 48): 195_000,
                      (32, 32): 104_000, (32, 16): 78_000, (32, 8): 65_000},
           (20, 16): {(64, 64): 419_000, (64, 56): 394_000, (64, 48): 369_000,
                      (32, 32): 235_000, (32, 16): 198_000, (32, 8): 180_000},
           (23, 16): {(64, 64): 483_000, (64, 56): 456_000, (64, 48): 429_000,
                      (32, 32): 284_000, (32, 16): 244_000, (32, 8): 224_000},
           (40, 16): {(64, 64): 934_000, (64, 56): 897_000, (64, 48): 860_000,
                      (32, 32): 648_000, (32, 16): 588_000, (32, 8): 558_000},
           (98, 16): {(64, 64): 240_000, (64, 56): 233_000, (64, 48): 200_000,
                      (32, 32): 96_000, (32, 16): 72_000, (32, 8): 60_000},
           (99, 16): {(64, 64): 300_000, (64, 56): 280_000, (64, 48): 260_000,
                      (32, 32): 120_000, (32, 16): 96_000, (32, 8): 60_000}}
WIDE = (1988, 2948)   # the 128-disparity frame


@pytest.fixture
def k3_table(monkeypatch):
    """``build`` replaced by a library whose guided_wta_smem_bytes reads
    K3_SMEM; the picker's cache cleared around the test."""
    class Lib:
        @staticmethod
        def guided_wta_smem_bytes(radius, cols, rows, size_d):
            return K3_SMEM[radius, size_d][cols, rows]

    monkeypatch.setattr(_kernels, "build", lambda *a: {"lib": Lib})
    _kernels.guided_wta_tile.cache_clear()
    yield
    _kernels.guided_wta_tile.cache_clear()


def test_occupancy_comes_before_height():
    # 32 rows fit one CTA per SM, 16 and 8 fit two (8 fits four, capped)
    table = {32: 120_000, 16: 90_000, 8: 50_000}
    assert _kernels._pick_rows(table, 2, *BIG, N_SM) == 16
    assert _kernels._pick_rows(table, 4, *BIG, N_SM) == 8
    assert _kernels._pick_rows(table, 1, *BIG, N_SM) == 32


@pytest.mark.parametrize("hw,rows", [(BIG, 32), (SMALL, 16), ((96, 400), 8),
                                     ((64, 64), 8), ((4096, 4096), 32)])
def test_tallest_height_with_a_cta_per_sm(hw, rows):
    """All three give two CTAs per SM: the tallest that still gives the
    frame N_SM CTAs wins; a frame too small for any gets the lowest."""
    table = {32: 95_820, 16: 68_364, 8: 54_636}
    assert _kernels._pick_rows(table, 2, *hw, N_SM) == rows


def test_none_when_nothing_fits_one_block():
    assert _kernels._pick_rows({32: 232_449, 16: 300_000}, 2, *BIG, N_SM) is None
    assert _kernels._pick_rows({}, 2, *BIG, N_SM) is None
    assert _kernels._pick_rows({32: 232_449, 16: 232_448}, 2, *BIG, N_SM) == 16


def test_batch_size_never_enters():
    """Neither the picker nor K3's tile takes the batch size, so a batch
    computes each frame as a lone launch does."""
    assert list(inspect.signature(_kernels._pick_rows).parameters) == [
        "smem_by_rows", "per_sm", "h", "w", "n_sm", "tile_w"]
    assert list(inspect.signature(_kernels.guided_wta_tile).parameters) == [
        "radius", "size_d", "h", "w", "n_sm"]
    assert list(inspect.signature(_kernels.guided_wta_dual_tile_rows).parameters) == [
        "radius", "reach"]
    assert "n" not in inspect.signature(_kernels.guided_wta_dual_stream_band_rows).parameters
    assert "n" not in inspect.signature(_kernels.guided_wta_stream_band_rows).parameters


@pytest.mark.parametrize("radius,size_d,hw,tile", [
    (9, 16, SMALL, (32, 32)), (9, 16, BIG, (64, 56)), (9, 64, SMALL, (32, 32)),
    (9, 64, BIG, (64, 56)), (9, 128, WIDE, (64, 56)), (9, 128, SMALL, (32, 32)),
    (9, 16, (576, 768), (64, 56)), (9, 16, (864, 1152), (64, 64)),
    (9, 16, (1504, 2048), (64, 64)), (9, 16, (1992, 1504), (64, 64)),
    (20, 16, BIG, (32, 16)), (23, 16, BIG, (32, 8)), (1, 1, SMALL, (32, 32)),
    (1, 1, BIG, (64, 56)), (98, 16, BIG, (64, 48)), (99, 16, BIG, (32, 16))])
def test_k3_tile_rows(k3_table, radius, size_d, hw, tile):
    """K3: of the tiles that fit their CTAs per SM, the one whose waves
    take the least time (288x384: one wave of 108 32x32 CTAs, 0.763,
    against one of 64x48, 0.821; 6 MP: 13 waves of 64x56, 11.45, against
    12 of 64x64, 12.0); where none does, 32 columns, occupancy first, then
    the tallest."""
    assert _kernels.guided_wta_tile(radius, size_d, *hw, N_SM) == tile


def test_k3_tile_by_waves(k3_table):
    """1408x1536: 528 CTAs of 64x64, four whole waves (4.0), against five
    of 64x56 (4.405); 64 columns more make five waves of either, and
    64x56's are the shorter."""
    assert _kernels.guided_wta_tile(9, 16, 1408, 1536, N_SM) == (64, 64)
    assert _kernels.guided_wta_tile(9, 16, 1408, 1600, N_SM) == (64, 56)


def test_k3_tile_rows_raises_when_nothing_fits(k3_table):
    for hw in (SMALL, BIG):
        with pytest.raises(ValueError, match="shared memory"):
            _kernels.guided_wta_tile(40, 16, *hw, N_SM)


# K4's shared memory (bytes, rounded) at column reach 15 (16
# disparities): every tile at two CTAs per SM (R=1, 9), 16 and 8 rows at
# two (R=12), 16 and 8 at one (R=20), 8 rows alone (R=22), none (R=23).
K4_SMEM = {1: {32: 32_000, 16: 18_000, 8: 11_000},
           9: {32: 99_000, 16: 76_000, 8: 64_000},
           12: {32: 134_000, 16: 107_000, 8: 94_000},
           20: {32: 252_000, 16: 216_000, 8: 198_000},
           22: {32: 288_000, 16: 249_000, 8: 230_000},
           23: {32: 306_000, 16: 267_000, 8: 247_000}}
# K5's shared memory at reach 15 is about base + 170 bytes a band row;
# {(radius, step): base}, rounded: 16-row steps fit one block up to R=25,
# 8-row steps up to R=31.
K5_BASE = {(9, 16): 96_300, (9, 8): 63_300, (25, 16): 226_500, (25, 8): 175_000,
           (31, 16): 288_000, (31, 8): 229_600, (32, 16): 299_000, (32, 8): 239_400}


@pytest.fixture
def dual_tables(monkeypatch):
    """``build`` replaced by a library whose K4 and K5 shared-memory
    functions read K4_SMEM and K5_BASE; the pickers' caches cleared."""
    class Lib:
        @staticmethod
        def guided_wta_dual_smem_bytes(radius, rows, reach):
            return K4_SMEM[radius][rows]

        @staticmethod
        def guided_wta_dual_stream_smem_bytes(radius, band, reach, step):
            return K5_BASE[radius, step] + 170 * band

    pickers = (_kernels.guided_wta_dual_tile_rows, _kernels.guided_wta_dual_stream_step,
               _kernels.guided_wta_dual_stream_band_rows)
    monkeypatch.setattr(_kernels, "build", lambda *a: {"lib": Lib})
    for f in pickers:
        f.cache_clear()
    yield
    for f in pickers:
        f.cache_clear()


@pytest.mark.parametrize("radius,rows", [(1, 32), (9, 32), (12, 16), (20, 16), (22, 8)])
def test_k4_tile_rows(dual_tables, radius, rows):
    """K4 takes K3's rule: occupancy first, then the tallest, whatever the
    frame (at R=9, 32 rows at 288x384 too: 108 CTAs)."""
    assert _kernels.guided_wta_dual_tile_rows(radius, 15) == rows


def test_k4_tile_rows_raises_when_nothing_fits(dual_tables):
    with pytest.raises(ValueError, match="shared memory"):
        _kernels.guided_wta_dual_tile_rows(23, 15)


@pytest.mark.parametrize("radius,step", [(9, 16), (25, 16), (31, 8), (32, None)])
def test_k5_step(dual_tables, radius, step):
    """16-row steps where the lowest band fits one block, else 8; K5 fits
    (the automatic dual route may take it) wherever either does."""
    assert _kernels.guided_wta_dual_stream_step(radius, 15) == step
    assert _kernels.dual_stream_fits(radius, 15) == (step is not None)


@pytest.mark.parametrize("step", [16, 8])
@pytest.mark.parametrize("hw,band", [(BIG, 96), (SMALL, 24), ((4096, 4096), 96),
                                     ((64, 64), 8)])
def test_k5_band_rows(dual_tables, step, hw, band):
    """At R=9 every band of 128 rows or fewer fits two CTAs per SM; the
    bands stop at 96, and the tallest of those that still gives the frame
    a CTA per SM wins (288x384: 12 x 12 = 144 CTAs at 24 rows)."""
    assert _kernels.guided_wta_dual_stream_band_rows(9, 15, *hw, N_SM, step) == band


def test_k5_band_rows_raises_when_nothing_fits(dual_tables):
    with pytest.raises(ValueError, match="shared memory"):
        _kernels.guided_wta_dual_stream_band_rows(32, 15, *BIG, N_SM, 8)


# K1's shared memory at 16 disparities is about base + 219 bytes a band
# row (the band's input windows; its guide statistics live in L2);
# {(radius, step): base}, rounded: 16-row steps fit one block up to R=32,
# 8-row steps up to R=37.
K1_BASE = {(9, 16): 80_000, (9, 8): 54_600, (32, 16): 225_000, (32, 8): 170_000,
           (33, 16): 236_000, (33, 8): 180_000, (37, 16): 290_000, (37, 8): 229_000,
           (38, 16): 300_000, (38, 8): 240_000}


@pytest.fixture
def k1_table(monkeypatch):
    """``build`` replaced by a library whose guided_wta_stream_smem_bytes
    (radius, band, slice count, step) reads K1_BASE; the pickers' caches
    cleared."""
    class Lib:
        @staticmethod
        def guided_wta_stream_smem_bytes(radius, band, size_d, step):
            return K1_BASE[radius, step] + 219 * band

    pickers = (_kernels.guided_wta_stream_step, _kernels.guided_wta_stream_band_rows)
    monkeypatch.setattr(_kernels, "build", lambda *a: {"lib": Lib})
    for f in pickers:
        f.cache_clear()
    yield
    for f in pickers:
        f.cache_clear()


@pytest.mark.parametrize("radius,step", [(9, 16), (32, 16), (33, 8), (37, 8), (38, None)])
def test_k1_step(k1_table, radius, step):
    """16-row steps where the lowest band fits one block, else 8, else
    none (the wrapper then raises from the band picker)."""
    assert _kernels.guided_wta_stream_step(radius, 16) == step


@pytest.mark.parametrize("step", [16, 8])
@pytest.mark.parametrize("hw,band", [(BIG, 96), (SMALL, 8), ((4096, 4096), 96),
                                     ((64, 64), 8)])
def test_k1_band_rows(k1_table, step, hw, band):
    """At R=9 every band fits two CTAs per SM; the bands stop at 96, and
    the tallest of those that still gives the frame a CTA per SM wins
    (288x384: 6 x 36 = 216 CTAs of 64 columns at 8 rows, 108 at 16)."""
    assert _kernels.guided_wta_stream_band_rows(9, 16, *hw, N_SM, step) == band


def test_k1_band_rows_raises_when_nothing_fits(k1_table):
    with pytest.raises(ValueError, match="shared memory"):
        _kernels.guided_wta_stream_band_rows(38, 16, *BIG, N_SM, 8)
