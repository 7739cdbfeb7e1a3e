"""The port's image codecs, I/O front end and write_mat normalizer against
the JAX package's on the same files: every reader returns the same
array, every writer writes the same bytes (read back by the JAX
readers), and the normalizer equals ``reference.write_mat_normalize``
with the native codec and without it."""

import os

import numpy as np
import pytest

from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu import metrics as jax_metrics
from stereo_matching_cuda_tpu.utils import (
    imagefmt as jax_imagefmt, io as jax_io, jpeg as jax_jpeg, legacyfmt as jax_legacyfmt,
    png as jax_png, pnm as jax_pnm, synth as jax_synth)
from stereo_matching_cuda_tpu_torch import metrics
from stereo_matching_cuda_tpu_torch.utils import (
    imagefmt, io, jpeg, legacyfmt, png, pnm, synth)

from test_imagefmt import _encode_adam7
from test_legacyfmt import _pic_bytes, _psd_bytes

RNG = np.random.default_rng(8)


def _img(*shape, dtype=np.uint8):
    hi = 65536 if dtype == np.uint16 else 256
    return RNG.integers(0, hi, size=shape).astype(dtype)


def _smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 4
    return base.astype(np.uint8)


def _pil(tmp_path, name, arr, **kw):
    image = pytest.importorskip("PIL.Image")
    p = str(tmp_path / name)
    image.fromarray(arr).save(p, **kw)
    return p


def _bytes(tmp_path, name, blob):
    p = tmp_path / name
    p.write_bytes(blob)
    return str(p)


def _written(write, name, arr):
    def build(tmp_path):
        p = str(tmp_path / name)
        write(p, arr)
        return p
    return build


# (id, function writing a file with the JAX writers or built in-test as
# the JAX package's codec tests build theirs, readers to compare)
FIXTURES = [
    ("png8-gray", _written(jax_png.write_png, "g.png", _img(13, 17)), ["png.read_png"]),
    ("png8-rgb", _written(jax_png.write_png, "c.png", _img(9, 21, 3)), ["png.read_png"]),
    ("png8-rgba-native", _written(jax_io.write_png, "a.png", _img(8, 9, 4)), ["png.read_png"]),
    ("png16-gray", _written(jax_png.write_png, "g16.png", _img(23, 41, dtype=np.uint16)),
     ["png.read_png"]),
    ("png16-rgb", _written(jax_png.write_png, "c16.png", _img(9, 13, 3, dtype=np.uint16)),
     ["png.read_png"]),
    ("png-adam7", lambda t: _bytes(t, "i.png", _encode_adam7(_img(13, 17, 3))), ["png.read_png"]),
    ("pgm", _written(jax_pnm.write_pnm, "g.pgm", _img(13, 17)), ["pnm.read_pnm"]),
    ("pgm16", _written(jax_pnm.write_pnm, "g16.pgm", _img(13, 17, dtype=np.uint16)),
     ["pnm.read_pnm"]),
    ("ppm", _written(jax_pnm.write_pnm, "c.ppm", _img(9, 11, 3)), ["pnm.read_pnm"]),
    ("pfm-gray", _written(jax_pnm.write_pfm, "g.pfm",
                          RNG.normal(0, 30, (7, 12)).astype(np.float32)), ["pnm.read_pfm"]),
    ("pfm-rgb", _written(jax_pnm.write_pfm, "c.pfm",
                         RNG.normal(0, 30, (7, 12, 3)).astype(np.float32)), ["pnm.read_pfm"]),
    ("bmp", _written(jax_imagefmt.write_bmp, "c.bmp", _img(11, 14, 3)), ["imagefmt.read_bmp"]),
    ("tga", _written(jax_imagefmt.write_tga, "c.tga", _img(11, 14, 3)), ["imagefmt.read_tga"]),
    ("tga-gray", _written(jax_imagefmt.write_tga, "g.tga", _img(11, 14)), ["imagefmt.read_tga"]),
    ("hdr", _written(jax_imagefmt.write_hdr, "x.hdr",
                     (RNG.random((13, 37, 3)) * 4).astype(np.float32)), ["imagefmt.read_hdr"]),
    ("jpeg-baseline", _written(lambda p, a: jax_jpeg.write_jpeg(p, a, quality=90), "b.jpg",
                               _smooth(41, 59)), ["jpeg.read_jpeg"]),
    ("jpeg-baseline-pil-420", lambda t: _pil(t, "b420.jpg", _smooth(41, 59), quality=85,
                                             subsampling=2), ["jpeg.read_jpeg"]),
    ("jpeg-progressive", lambda t: _pil(t, "p.jpg", _smooth(41, 59, 3), quality=90,
                                        subsampling=2, progressive=True), ["jpeg.read_jpeg"]),
    ("jpeg-progressive-gray", lambda t: _pil(t, "pg.jpg", _smooth(33, 40)[..., 0], quality=90,
                                             progressive=True), ["jpeg.read_jpeg"]),
    ("gif", lambda t: _pil(t, "t.gif", _img(21, 33, 3)), ["legacyfmt.read_gif"]),
    ("gif-interlaced", lambda t: _pil(t, "i.gif", np.tile(np.arange(64, dtype=np.uint8) * 4,
                                                         (17, 1)), interlace=True),
     ["legacyfmt.read_gif"]),
    ("psd-raw", lambda t: _bytes(t, "r.psd", _psd_bytes(_img(9, 14, 3), 0)),
     ["legacyfmt.read_psd"]),
    ("psd-rle-gray", lambda t: _bytes(t, "g.psd", _psd_bytes(_img(11, 13), 1)),
     ["legacyfmt.read_psd"]),
    ("psd-16bit", lambda t: _bytes(t, "w.psd", _psd_bytes(_img(6, 8, 3).astype(np.uint16) * 257, 0)),
     ["legacyfmt.read_psd"]),
    ("pic", lambda t: _bytes(t, "t.pic", _pic_bytes(_img(7, 19, 3), False)),
     ["legacyfmt.read_pic"]),
    ("pic-rle", lambda t: _bytes(t, "r.pic", _pic_bytes(np.repeat(_img(7, 1, 3), 19, 1), True)),
     ["legacyfmt.read_pic"]),
]

PORT = {"png": png, "pnm": pnm, "jpeg": jpeg, "imagefmt": imagefmt, "legacyfmt": legacyfmt,
        "io": io}
JAX = {"png": jax_png, "pnm": jax_pnm, "jpeg": jax_jpeg, "imagefmt": jax_imagefmt,
       "legacyfmt": jax_legacyfmt, "io": jax_io}


def _call(modules, name, path):
    mod, fn = name.split(".")
    return getattr(modules[mod], fn)(path)


@pytest.mark.parametrize("build,readers", [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_port_readers_equal_jax_readers(tmp_path, build, readers):
    path = build(tmp_path)
    native = ["io.read_png"] if readers == ["png.read_png"] else []
    for name in readers + native + ["io.read_image"]:
        got, want = _call(PORT, name, path), _call(JAX, name, path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


WRITES = [
    ("png.write_png", _img(13, 17), True),
    ("png.write_png", _img(9, 21, 3), True),
    ("png.write_png", _img(23, 41, dtype=np.uint16), True),
    ("io.write_png", _img(9, 21, 4), True),
    ("io.write_png", _img(23, 41, dtype=np.uint16), True),
    ("pnm.write_pnm", _img(9, 11, 3), True),
    ("pnm.write_pfm", RNG.normal(0, 30, (7, 12)).astype(np.float32), True),
    ("imagefmt.write_bmp", _img(11, 14, 3), True),
    ("imagefmt.write_tga", _img(11, 14, 3), True),
    ("imagefmt.write_hdr", (RNG.random((13, 37, 3)) * 4).astype(np.float32), False),
    ("jpeg.write_jpeg", _smooth(41, 59), False),
]


@pytest.mark.parametrize("name,arr,lossless", WRITES,
                         ids=[f"{w[0]}-{'x'.join(map(str, w[1].shape))}" for w in WRITES])
def test_port_writers_read_back_by_jax(tmp_path, name, arr, lossless):
    """The port's writer writes the JAX writer's bytes; the JAX reader
    reads it back (exactly, for the lossless formats)."""
    mod, fn = name.split(".")
    ext = {"write_png": "png", "write_pnm": "ppm", "write_pfm": "pfm", "write_bmp": "bmp",
           "write_tga": "tga", "write_hdr": "hdr", "write_jpeg": "jpg"}[fn]
    ours, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    getattr(PORT[mod], fn)(ours, arr)
    getattr(JAX[mod], fn)(theirs, arr)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = jax_io.read_image(ours)
    if lossless:
        np.testing.assert_array_equal(back, arr)
    else:
        np.testing.assert_array_equal(back, jax_io.read_image(theirs))


NORMALIZE_INPUTS = {
    "random": RNG.normal(0, 100, size=(64, 80)).astype(np.float32),
    "labels": RNG.integers(-15, 1, size=(48, 64)).astype(np.float32),
    "with-sentinel": np.where(RNG.random((32, 40)) < 0.1, -115.0,
                              RNG.integers(-15, 1, (32, 40))).astype(np.float32),
    "constant": np.full((6, 8), 3.25, np.float32),
    "extremes": np.array([[3.39e38, -115.0, 0.0, -15.0]], np.float32),
    "descending": np.arange(50, 0, -1, dtype=np.float32).reshape(5, 10),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("key", list(NORMALIZE_INPUTS))
def test_write_mat_normalize_equals_reference(monkeypatch, native, key):
    if native and not io.native_available():
        pytest.skip("native stereoio not built")
    if not native:
        monkeypatch.setattr(io, "_load_native", lambda: None)
    m = NORMALIZE_INPUTS[key]
    got = io.write_mat_normalize(m)
    assert got.dtype == np.uint8 and got.shape == m.shape
    np.testing.assert_array_equal(got, R.write_mat_normalize(m))


def test_write_scene_dir_equals_jax(tmp_path):
    sc = synth.make_scene(40, 64, ndisp=16, seed=3)
    synth.write_scene_dir(str(tmp_path / "port"), sc)
    jax_synth.write_scene_dir(str(tmp_path / "jax"), jax_synth.make_scene(40, 64, ndisp=16,
                                                                          seed=3))
    for f in ("im0.png", "im1.png", "disp0.pfm", "calib.txt"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_occlusion_stats_equals_jax():
    occ = np.where(RNG.random((30, 50)) < 0.2, -115.0, -3.0).astype(np.float32)
    assert metrics.occlusion_stats(occ, -15) == jax_metrics.occlusion_stats(occ, -15)


def test_port_io_loads_the_shared_native_library():
    assert os.path.samefile(os.path.dirname(io._SO_PATH), os.path.dirname(jax_io._SO_PATH))
    assert io.native_available() == jax_io.native_available()
