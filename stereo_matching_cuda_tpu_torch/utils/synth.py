"""Synthetic stereo scenes with exact integer ground-truth disparity.

A NumPy-only copy of ``stereo_matching_cuda_tpu/utils/synth.py``'s
``make_scene`` and ``write_scene_dir`` (:143-157) (the JAX package
cannot be imported where JAX is absent); the same seed renders the same
scene.  This module renders stereo pairs
with *known* geometry instead: textured fronto-parallel layers plus
staircase slants, composited far-to-near in both views, with the
occlusion set derived from the actual two-view visibility — i.e. the
ground truth is exact by construction, not estimated.

Conventions (match evaluate.py / Middlebury):
  - disparity d > 0: left pixel (x, y) corresponds to right pixel
    (x - d, y) — the pipeline's left labels are the negatives of these
    (SURVEY.md §2.5.7) and are scored as |d|;
  - GT value 0 = excluded pixel (metrics.bad_pixel_rate convention);
    every real layer therefore uses d >= 1;
  - left pixels not visible in the right view (geometric occlusion,
    including the x < d left border band) get GT 0 and are reported in
    the ``occluded`` mask so callers can score occlusion detection
    separately.

Each layer's texture lives on an x-extended domain [0, w + d_max) so
the right view can be rendered without inventing disoccluded content.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class _Layer:
    """One constant-disparity surface on the extended domain."""
    d: int                  # integer disparity, >= 1
    mask: np.ndarray        # bool (h, w_ext), support in left coords
    tex: np.ndarray         # uint8 (h, w_ext, 3)


def _texture(h: int, w_ext: int, rng: np.random.Generator,
             lo: int, hi: int) -> np.ndarray:
    """Smoothed color noise in [lo, hi): strong texture at the 1-2 px
    scale (unambiguous matching) without single-pixel speckle."""
    t = rng.integers(lo, hi, size=(h, w_ext, 3)).astype(np.float32)
    for axis in (0, 1):
        t = (t + np.roll(t, 1, axis) + np.roll(t, -1, axis)) / 3.0
    return np.clip(t, 0, 255).astype(np.uint8)


def _rect(h: int, w_ext: int, y0, y1, x0, x1) -> np.ndarray:
    m = np.zeros((h, w_ext), bool)
    m[y0:y1, x0:x1] = True
    return m


def make_scene(h: int = 240, w: int = 320, ndisp: int = 16,
               seed: int = 7) -> dict:
    """Render a layered scene.  Returns dict with ``left``/``right``
    uint8 (h, w, 3), ``gt`` float32 (h, w) positive disparities with 0
    at excluded (occluded) pixels, ``gt_all`` including occluded pixels,
    and the bool ``occluded`` mask."""
    if ndisp < 8:
        raise ValueError(f"need ndisp >= 8 to place the layers, got {ndisp}")
    d_max = ndisp - 1
    w_ext = w + d_max
    rng = np.random.default_rng(seed)

    def frac(a, b, n):   # scene coordinates scale with h/w
        return int(a * n / b)

    layers: list[_Layer] = []
    # background plane
    layers.append(_Layer(2, np.ones((h, w_ext), bool),
                         _texture(h, w_ext, rng, 20, 200)))
    # mid-depth large rectangle
    layers.append(_Layer(frac(6, 16, ndisp) or 3,
                         _rect(h, w_ext, frac(1, 10, h), frac(6, 10, h),
                               frac(1, 10, w), frac(55, 100, w)),
                         _texture(h, w_ext, rng, 60, 256)))
    # near rectangle overlapping it
    layers.append(_Layer(frac(11, 16, ndisp),
                         _rect(h, w_ext, frac(35, 100, h), frac(85, 100, h),
                               frac(40, 100, w), frac(75, 100, w)),
                         _texture(h, w_ext, rng, 0, 180)))
    # staircase slant: d steps from ~13 down to ~7 across x (a slanted
    # plane quantized to the integer-disparity grid, rendered as
    # constant-d strips)
    d_hi = frac(13, 16, ndisp)
    d_lo = frac(7, 16, ndisp)
    x0, x1 = frac(62, 100, w), frac(97, 100, w)
    y0, y1 = frac(5, 100, h), frac(45, 100, h)
    steps = d_hi - d_lo + 1
    tex_slant = _texture(h, w_ext, rng, 40, 230)
    for i in range(steps):
        sx0 = x0 + frac(i, steps, x1 - x0)
        sx1 = x0 + frac(i + 1, steps, x1 - x0)
        layers.append(_Layer(d_hi - i, _rect(h, w_ext, y0, y1, sx0, sx1),
                             tex_slant))
    # thin near bar: strong occluder
    layers.append(_Layer(d_max - 1,
                         _rect(h, w_ext, frac(15, 100, h), frac(95, 100, h),
                               frac(20, 100, w), frac(26, 100, w)),
                         _texture(h, w_ext, rng, 100, 256)))

    # far-to-near paint order; stable for equal d (later wins = arbitrary
    # but deterministic)
    order = sorted(range(len(layers)), key=lambda k: layers[k].d)

    left = np.zeros((h, w, 3), np.uint8)
    gt_all = np.zeros((h, w), np.int32)
    who_l = np.full((h, w), -1, np.int32)
    right = np.zeros((h, w, 3), np.uint8)
    who_r = np.full((h, w), -1, np.int32)
    for k in order:
        L = layers[k]
        m = L.mask[:, :w]
        left[m] = L.tex[:, :w][m]
        gt_all[m] = L.d
        who_l[m] = k
        # right view: layer k covers xr where its left support covers
        # xr + d (same texture sample — exact photometric consistency)
        m_sh = L.mask[:, L.d:L.d + w]
        right[m_sh] = L.tex[:, L.d:L.d + w][m_sh]
        who_r[m_sh] = k

    # left pixel (x, y) of layer k is visible in the right view iff the
    # right-view winner at xr = x - d is layer k
    ys, xs = np.indices((h, w))
    xr = xs - gt_all
    inside = xr >= 0
    same = np.zeros((h, w), bool)
    same[inside] = who_r[ys[inside], xr[inside]] == who_l[inside]
    occluded = ~(inside & same)
    gt = np.where(occluded, 0, gt_all).astype(np.float32)
    return {
        "left": left, "right": right, "gt": gt,
        "gt_all": gt_all.astype(np.float32), "occluded": occluded,
        "ndisp": ndisp,
    }



def write_scene_dir(scene_dir: str, scene: dict) -> None:
    """Write a scene as a Middlebury-layout directory (im0.png, im1.png,
    disp0.pfm, calib.txt) consumable by ``evaluate.evaluate_dataset``
    and the CLI's ``--eval``."""
    import os

    from .io import write_png
    from .pnm import write_pfm

    os.makedirs(scene_dir, exist_ok=True)
    write_png(os.path.join(scene_dir, "im0.png"), scene["left"])
    write_png(os.path.join(scene_dir, "im1.png"), scene["right"])
    write_pfm(os.path.join(scene_dir, "disp0.pfm"), scene["gt"])
    with open(os.path.join(scene_dir, "calib.txt"), "w") as f:
        f.write(f"ndisp={scene['ndisp']}\n")
