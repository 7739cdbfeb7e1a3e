"""The kernels' launch-shape choice on the CPU, with no card and no CUDA
toolkit: ``_kernels._pick_rows`` (K1, K4, K5) and K3's tile height
(``guided_wta_tile_rows``) on synthetic {rows: shared-memory bytes}
tables.  tests/test_torch_cuda.py checks K3's picks with the real
``guided_wta_smem_bytes`` on a card."""

import inspect

import pytest

from stereo_matching_cuda_tpu_torch.ops import _kernels

N_SM = 132            # an H100 SXM's SMs
SMALL, BIG = (288, 384), (1992, 3008)


# {(radius, size_d): {rows: bytes}}: K3's shared memory, rounded, where
# every tile gives two CTAs per SM (R=1, 9), only 16 and 8 rows fit one
# block (R=20), only 8 rows (R=23), none (R=40), and a made-up radius 99
# whose 32-row tile fits one CTA per SM and the others two.
K3_SMEM = {(1, 1): {32: 33_000, 16: 18_000, 8: 11_000},
           (9, 16): {32: 96_000, 16: 72_000, 8: 60_000},
           (9, 64): {32: 99_000, 16: 74_000, 8: 62_000},
           (9, 128): {32: 104_000, 16: 78_000, 8: 65_000},
           (20, 16): {32: 235_000, 16: 198_000, 8: 180_000},
           (23, 16): {32: 284_000, 16: 244_000, 8: 224_000},
           (40, 16): {32: 648_000, 16: 588_000, 8: 558_000},
           (99, 16): {32: 120_000, 16: 96_000, 8: 60_000}}


@pytest.fixture
def k3_table(monkeypatch):
    """``build`` replaced by a library whose guided_wta_smem_bytes reads
    K3_SMEM; the picker's cache cleared around the test."""
    class Lib:
        @staticmethod
        def guided_wta_smem_bytes(radius, rows, size_d):
            return K3_SMEM[radius, size_d][rows]

    monkeypatch.setattr(_kernels, "build", lambda *a: {"lib": Lib})
    _kernels.guided_wta_tile_rows.cache_clear()
    yield
    _kernels.guided_wta_tile_rows.cache_clear()


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
    """Neither the picker nor K3's tile height takes the batch size, so
    a batch computes each frame as a lone launch does."""
    assert list(inspect.signature(_kernels._pick_rows).parameters) == [
        "smem_by_rows", "per_sm", "h", "w", "n_sm", "tile_w"]
    assert list(inspect.signature(_kernels.guided_wta_tile_rows).parameters) == [
        "radius", "size_d"]


@pytest.mark.parametrize("radius,size_d,rows", [
    (9, 16, 32), (9, 64, 32), (9, 128, 32), (20, 16, 16), (23, 16, 8), (1, 1, 32),
    (99, 16, 16)])
def test_k3_tile_rows(k3_table, radius, size_d, rows):
    """K3: occupancy first, then the tallest, whatever the frame (at R=9:
    288x384 gets 12 x 9 = 108 CTAs, 6 MP 94 x 63 = 5,922)."""
    assert _kernels.guided_wta_tile_rows(radius, size_d) == rows


def test_k3_tile_rows_raises_when_nothing_fits(k3_table):
    with pytest.raises(ValueError, match="shared memory"):
        _kernels.guided_wta_tile_rows(40, 16)
