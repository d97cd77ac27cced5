"""The port's replacements for PyYAML, the PNG codec and cv2's resize and
undistort, against the libraries they replace (the JAX package reads its
data through them).

- load_dataset_config equals the JAX package's (yaml.full_load) on every
  file under configs/data and on inherit_from chains with default_path;
  yaml_subset equals yaml.full_load on flow lists, quotes, comments and
  exponents, and raises ValueError naming the line on what it leaves out.
- read_png equals cv2.imread(..., IMREAD_UNCHANGED) on files written by
  cv2, Pillow and write_png (8-bit RGB, RGBA and grey, 16-bit grey), and
  on files whose rows carry each of the five filter types, written here
  scanline by scanline.
- resize_linear and undistort within 1e-9 of cv2 on float64 at the
  configs' sizes; resize_nearest equal.
"""
import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml
from PIL import Image

from splatam_tpu.data.dataconfig import load_dataset_config as j_load
from splatam_tpu_torch.data import imgproc, yaml_subset
from splatam_tpu_torch.data.dataconfig import load_dataset_config
from splatam_tpu_torch.data.png import read_png, write_png

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG_YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "data", "**", "*.yaml"),
                            recursive=True))


# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIG_YAMLS, ids=lambda p: os.path.relpath(p, REPO))
def test_dataset_yaml_equals_pyyaml(path):
    assert load_dataset_config(path) == j_load(path)
    with open(path) as f:
        assert yaml_subset.loads(f.read()) == yaml.full_load(open(path))


def test_inherit_from_chain_and_default_path(tmp_path):
    (tmp_path / "default.yaml").write_text(
        "dataset_name: 'base'\ncamera_params:\n  png_depth_scale: 1000.0\n  fx: 1.0\n"
        "extra:\n  keep: 3\n")
    (tmp_path / "base.yaml").write_text(
        "camera_params:\n  image_height: 480\n  image_width: 640\n  fx: 500.0\n")
    (tmp_path / "mid.yaml").write_text(
        f"inherit_from: {tmp_path / 'base.yaml'}\ncamera_params:\n  fy: 501.5\n"
        "  crop_edge: 8\n")
    (tmp_path / "top.yaml").write_text(
        f"inherit_from: '{tmp_path / 'mid.yaml'}'\ndataset_name: tum\ncamera_params:\n"
        "  fx: 517.3  # overrides base\n")
    for name in ("top.yaml", "mid.yaml", "base.yaml"):
        path = str(tmp_path / name)
        for default in (None, str(tmp_path / "default.yaml")):
            assert load_dataset_config(path, default) == j_load(path, default), (name, default)
    top = load_dataset_config(str(tmp_path / "top.yaml"), str(tmp_path / "default.yaml"))
    assert top["camera_params"] == {"png_depth_scale": 1000.0, "fx": 517.3, "image_height": 480,
                                    "image_width": 640, "fy": 501.5, "crop_edge": 8}
    assert top["extra"] == {"keep": 3} and top["dataset_name"] == "tum"


SUBSET_TEXT = """\
# a leading comment
dataset_name: "tum"   # trailing comment
name2: 'it''s quoted'
plain: some/bare/path_0.png
flags:
  a: true
  b: False
  c: null
  d: ~
  e:
camera_params:
  image_height: 480
  fx: 517.3
  small: 1.5e-3
  big: -2.0E+4
  dot: .5
  trailing_dot: 7.
  neg: -12
  pos: +3
  inf: .inf
  distortion: [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]
  names: ['a, b', "c", plain, 3, 4.5, true]
  empty: []
  hash: 'a # not a comment'
nested:
    deeper:
        value: 1
    other: x
"""


def test_subset_constructs_equal_pyyaml():
    assert yaml_subset.loads(SUBSET_TEXT) == yaml.full_load(SUBSET_TEXT)


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb:\n  - x\n  - y\n", 3),  # block sequence
    ("a: &anchor 1\n", 1),
    ("a: *alias\n", 1),
    ("a: {b: 1}\n", 1),  # flow map
    ("a: |\n  text\n", 1),  # block scalar
    ("a: [1, [2, 3]]\n", 1),  # nested flow list
    ("a: [1, 2,\n  3]\n", 1),  # flow list over two lines
    ("a: 1e-5\n", 1),  # a string in YAML 1.1
    ("a: 010\n", 1),  # octal in YAML 1.1
    ("a: yes\n", 1),  # a boolean in YAML 1.1
    ("a: 1\n\tb: 2\n", 2),  # tab indentation
    ("a:\n    b: 1\n  c: 2\n", 3),  # misaligned dedent
    ("a: 1\na: 2\n", 2),  # duplicate key
    ("---\na: 1\n", 1),  # document marker
    ("just a string\n", 1),
    ("a: 'open\n", 1),
])
def test_subset_refuses_what_it_leaves_out(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        yaml_subset.loads(text)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _image(kind: str, seed: int = 0, h: int = 23, w: int = 31) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape, dtype = {"rgb8": ((h, w, 3), np.uint8), "rgba8": ((h, w, 4), np.uint8),
                    "grey8": ((h, w), np.uint8), "grey16": ((h, w), np.uint16)}[kind]
    smooth = np.add.outer(np.arange(h), np.arange(w)) * 3  # filters predict well here
    if len(shape) == 3:
        smooth = smooth[..., None]
    noise = rng.integers(0, np.iinfo(dtype).max, size=shape, dtype=np.int64)
    return ((smooth + (noise >> 4)) % (np.iinfo(dtype).max + 1)).astype(dtype)


def _cv2_read(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    return img


def _cv2_write(path, img):
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR if img.shape[2] == 3 else cv2.COLOR_RGBA2BGRA)
    assert cv2.imwrite(str(path), img)


def _filter_row(kind: int, cur: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """PNG filter `kind` applied to one reconstructed row (bytes)."""
    cur, prior = cur.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (a + prior) >> 1
    else:
        p = a + prior - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
    return ((cur - pred) % 256).astype(np.uint8)


def _write_filtered(path, img: np.ndarray, kinds, interlace: int = 0) -> None:
    """A PNG whose row y carries filter kinds[y % len(kinds)]."""
    chans = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    bpp = chans * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(img.shape[0], -1)
    prior = np.zeros(rows.shape[1], np.uint8)
    out = bytearray()
    for y, row in enumerate(rows):
        kind = kinds[y % len(kinds)]
        out += bytes([kind]) + _filter_row(kind, row, prior, bpp).tobytes()
        prior = row

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ctype = {1: 0, 3: 2, 4: 6}[chans]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype,
                                           0, 0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey8", "grey16"])
@pytest.mark.parametrize("writer", ["cv2", "pillow", "write_png"])
def test_read_png_equals_cv2(tmp_path, kind, writer):
    img = _image(kind, seed=len(kind) + len(writer))
    path = tmp_path / f"{kind}.png"
    if writer == "cv2":
        _cv2_write(path, img)
    elif writer == "pillow":
        Image.fromarray(img).save(path)  # adaptive filters
    else:
        write_png(str(path), img)
    got = read_png(str(path))
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, _cv2_read(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey8", "grey16"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png_every_filter(tmp_path, kind, filters):
    img = _image(kind, seed=7)
    path = tmp_path / "f.png"
    _write_filtered(path, img, filters)
    np.testing.assert_array_equal(read_png(str(path)), _cv2_read(path))
    np.testing.assert_array_equal(read_png(str(path)), img)


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_write_png_filters_read_back(tmp_path, kind, filter_type):
    """write_png's filtered rows, read by cv2 and by read_png."""
    img = _image(kind, seed=filter_type)
    write_png(str(tmp_path / "w.png"), img, filter_type=filter_type)
    np.testing.assert_array_equal(_cv2_read(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)


def test_read_png_refuses_interlaced_and_palette(tmp_path):
    _write_filtered(tmp_path / "i.png", _image("rgb8"), (0,), interlace=1)
    with pytest.raises(ValueError, match="i.png: interlaced"):
        read_png(str(tmp_path / "i.png"))
    Image.fromarray(_image("rgb8")).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="p.png: palette"):
        read_png(str(tmp_path / "p.png"))


# ---------------------------------------------------------------------------
# Resize and undistort
# ---------------------------------------------------------------------------

# (source H, W) -> (H, W): ScanNet's 1296x968 -> 640x480, SplaTAM-S's exact
# 2x, the configs' sizes down to the tests' 48x64, the iPhone's 1920x1440
# halves and quarters, an upscale and odd sizes.
RESIZES = [((968, 1296), (480, 640)), ((680, 1200), (340, 600)), ((680, 1200), (48, 64)),
           ((480, 640), (48, 64)), ((1440, 1920), (720, 960)), ((1440, 1920), (360, 480)),
           ((37, 53), (101, 77)), ((41, 29), (13, 17)), ((30, 40), (30, 40))]


@pytest.mark.parametrize("src, dst", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_cv2(src, dst):
    rng = np.random.default_rng(src[0] * dst[1])
    h, w = dst
    for shape in (src, src + (3,)):
        img = rng.uniform(0, 255, shape)
        got = imgproc.resize_linear(img, h, w)
        ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(imgproc.resize_nearest(img, h, w),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


TUM_FR1_DISTORTION = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


@pytest.mark.parametrize("size", [(480, 640), (48, 64), (37, 53)])
def test_undistort_matches_cv2(size):
    rng = np.random.default_rng(size[1])
    k = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
    k[:2] *= size[0] / 480  # the camera of an image of this size
    for shape in (size, size + (3,)):
        img = rng.uniform(0, 255, shape)
        got = imgproc.undistort(img, k, TUM_FR1_DISTORTION)
        np.testing.assert_allclose(got, cv2.undistort(img, k, TUM_FR1_DISTORTION),
                                   rtol=0, atol=1e-9)
