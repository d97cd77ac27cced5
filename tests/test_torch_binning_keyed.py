"""The structure build over 32-bit keys (binning.build_bins_keyed: the
expansion, a stable sort, the scatter; on the card csrc/binning.cu's
bins_expand and bins_scatter) against the int64 build (build_bins_plain),
bit for bit, on the CPU, where build_bins_keyed runs the kernels' plain
versions: the kernels' algorithm in PyTorch.

Cases: the cameras of slam_bench's two configurations (tum 640x480,
replica_bench 1200x680) at a reduced map, with depths drawn at random and
on one plane (every pair of a tile tied on its key, so the stable sort's
slot order decides); a band keyed by its full image's tile grid; direct_j
0, 1 and 2; an empty map; a Gaussian whose rectangle is the whole grid;
Gaussians with no pairs between the others. And the key's width: every
camera of configs/ and slam_bench/configs/ keys its pairs in 31 bits, 32
with direct_j's extra bit."""
import glob
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api, binning
from splatam_tpu_torch.render.projection import Projected, ProjectedAux
from splatam_tpu_torch.scripts import scene
from splatam_tpu_torch.slam.config import load_experiment_config

ROOT = Path(__file__).resolve().parents[1]
# slam_bench/configs/{tum,replica_bench}.json's cameras
CAMERAS = {"tum": Camera(height=480, width=640, fx=517.3, fy=516.5, cx=318.6, cy=255.3),
           "replica_bench": Camera(height=680, width=1200, fx=600.0, fy=600.0, cx=599.5,
                                   cy=339.5)}
N = 3000


def assert_same_bins(got: binning.Bins, ref: binning.Bins) -> None:
    assert got.n_pairs == ref.n_pairs and got.n_culled == ref.n_culled == 0
    for field in ("pair_gauss", "tile_start", "offsets", "counts", "dst"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype == torch.int32, field
        assert torch.equal(a, b), field


def both(proj, aux, cam: Camera, **opts):
    args = (proj, aux, cam.width, cam.height, cam.far)
    return binning.build_bins_keyed(*args, **opts), binning.build_bins_plain(*args, **opts)


def projected(cam: Camera, planar: bool, seed: int = 0):
    """The synthetic map (scripts/scene.py) projected through cam at the
    identity pose; planar puts every centre at one depth."""
    gm, _, _, _ = scene.synthetic_scene(N, cam.width, cam.height, 1.0, "cpu", seed=seed)
    means = gm.means3d.clone()
    if planar:
        means[:, 2] = float(means[:, 2].median())
    return api.project_gaussians(cam, means, gm.unnorm_rotations, gm.logit_opacities,
                                 gm.log_scales, gm.active)


@pytest.mark.parametrize("direct_j", [0, 1, 2])
@pytest.mark.parametrize("planar", [False, True], ids=["depths", "plane"])
@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_keyed_build_equals_the_int64_build(camera, planar, direct_j):
    cam = CAMERAS[camera]
    proj, aux = projected(cam, planar)
    got, ref = both(proj, aux, cam, direct_j=direct_j)
    assert ref.n_pairs > N  # the map covers the image, most Gaussians several tiles
    if planar:  # keys tie inside tiles: the stable order is what is tested
        num_tiles = ref.tile_start.numel() - 1
        tiles = torch.repeat_interleave(torch.arange(num_tiles), torch.diff(ref.tile_start))
        q = binning.quantized_depth(proj.depth, binning.depth_bits_for(num_tiles))
        q = q[ref.pair_gauss.long()]
        assert int(((tiles[1:] == tiles[:-1]) & (q[1:] == q[:-1])).sum()) > ref.n_pairs // 2
    assert_same_bins(got, ref)


@pytest.mark.parametrize("direct_j", [0, 2])
def test_keyed_build_of_a_band_keys_by_the_full_image(direct_j):
    """One 640x128 row band of tum's image, keyed by the full 640x480 grid
    (parallel/spatial.py's band structures): fewer depth bits than the
    band's own grid would give."""
    full = CAMERAS["tum"]
    band = full._replace(height=128, cy=full.cy - 176.0)
    gm, _, _, _ = scene.synthetic_scene(N, full.width, full.height, 1.0, "cpu", seed=3)
    proj, aux = api.project_gaussians(band, gm.means3d, gm.unnorm_rotations,
                                      gm.logit_opacities, gm.log_scales, gm.active,
                                      lim_wh=(full.width, full.height))
    assert binning.depth_bits_for(40 * 30) < binning.depth_bits_for(40 * 8)
    got, ref = both(proj, aux, band, full_wh=(full.width, full.height), direct_j=direct_j)
    assert ref.n_pairs > 0
    assert_same_bins(got, ref)


def synthetic_aux(cam: Camera, n: int, seed: int):
    """A projection drawn directly: rectangles inside the grid, depths from
    0.005 to 200 (both clamps of quantized_depth), a third invisible."""
    gx, gy = binning.grid_shape(cam.width, cam.height)
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, gx, n), rng.integers(0, gy, n)
    w = np.minimum(rng.integers(1, 6, n), gx - x0)
    h = np.minimum(rng.integers(1, 6, n), gy - y0)
    depth = torch.tensor(np.exp(rng.uniform(math.log(0.005), math.log(200.0), n)),
                         dtype=torch.float32)
    visible = torch.tensor(rng.uniform(size=n) > 1 / 3)
    zeros = torch.zeros((n, 2), dtype=torch.float32)
    proj = Projected(xy=zeros, depth=depth, conic=torch.zeros((n, 3)), opacity=zeros[:, 0])
    aux = ProjectedAux(radius=torch.ones(n, dtype=torch.int32),
                       rect_min=torch.tensor(np.stack([x0, y0], 1), dtype=torch.int64),
                       rect_wh=torch.tensor(np.stack([w, h], 1), dtype=torch.int64),
                       visible=visible)
    return proj, aux


@pytest.mark.parametrize("direct_j", [0, 2])
def test_keyed_build_with_gaussians_of_no_pairs_between_the_others(direct_j):
    cam = CAMERAS["tum"]
    proj, aux = synthetic_aux(cam, 500, seed=1)
    assert not bool(aux.visible.all())
    got, ref = both(proj, aux, cam, direct_j=direct_j)
    assert bool((ref.counts == 0).any())
    assert_same_bins(got, ref)


@pytest.mark.parametrize("direct_j", [0, 2])
def test_keyed_build_with_a_gaussian_over_the_whole_grid(direct_j):
    cam = CAMERAS["tum"]
    gx, gy = binning.grid_shape(cam.width, cam.height)
    proj, aux = synthetic_aux(cam, 200, seed=2)
    aux.rect_min[7] = 0
    aux.rect_wh[7] = torch.tensor([gx, gy])
    aux.visible[7] = True
    got, ref = both(proj, aux, cam, direct_j=direct_j)
    assert int(ref.counts[7]) == gx * gy
    assert bool((ref.tile_start[1:] > ref.tile_start[:-1]).all())  # no tile is empty
    assert_same_bins(got, ref)


@pytest.mark.parametrize("n", [0, 50])
def test_keyed_build_of_an_empty_map(n):
    """No Gaussian, or none visible: no pairs, every tile empty."""
    cam = CAMERAS["replica_bench"]
    proj, aux = synthetic_aux(cam, n, seed=4)
    aux = aux._replace(visible=torch.zeros(n, dtype=torch.bool))
    got, ref = both(proj, aux, cam)
    assert ref.n_pairs == 0 and not bool(ref.tile_start.any())
    assert_same_bins(got, ref)


def test_build_bins_on_the_cpu_is_the_int64_build():
    """build_bins routes CPU tensors to build_bins_plain and counts the build."""
    cam = CAMERAS["tum"]
    proj, aux = synthetic_aux(cam, 300, seed=5)
    before = dict(binning.build_bins.totals)
    launches = binning.bins_expand.launches, binning.bins_scatter.launches
    b = binning.build_bins(proj, aux, cam.width, cam.height)
    assert_same_bins(b, binning.build_bins_plain(proj, aux, cam.width, cam.height))
    assert binning.build_bins.totals["builds"] == before["builds"] + 1
    assert binning.build_bins.totals["pairs"] == before["pairs"] + b.n_pairs
    assert (binning.bins_expand.launches, binning.bins_scatter.launches) == launches


def _image_sizes(node, found: set) -> None:
    """Every (width, height) a config names: each *height* key beside its
    *width* key, and viz_h beside viz_w."""
    if not isinstance(node, dict):
        return
    for k, v in node.items():
        if isinstance(v, dict):
            _image_sizes(v, found)
        elif isinstance(k, str) and "height" in k and k.replace("height", "width") in node:
            found.add((int(node[k.replace("height", "width")]), int(v)))
        elif k == "viz_h" and "viz_w" in node:
            found.add((int(node["viz_w"]), int(v)))


def config_image_sizes() -> set:
    found = set()
    for path in sorted(glob.glob(str(ROOT / "configs" / "**" / "*.py"), recursive=True)):
        if Path(path).name != "_template.py":
            _image_sizes(load_experiment_config(path), found)
    for path in sorted(glob.glob(str(ROOT / "configs" / "data" / "**" / "*.yaml"),
                                 recursive=True)):
        _image_sizes(yaml.safe_load(Path(path).read_text()), found)
    for path in sorted((ROOT / "slam_bench" / "configs").glob("*.json")):
        cam = json.loads(path.read_text())["camera"]
        found.add((cam["width"], cam["height"]))
    return found


def test_every_configured_camera_keys_its_pairs_in_32_bits():
    sizes = config_image_sizes()
    assert {(640, 480), (1200, 680), (1296, 968), (960, 720), (160, 120)} <= sizes
    for width, height in sizes:
        gx, gy = binning.grid_shape(width, height)
        bits = binning.depth_bits_for(gx * gy)
        largest = ((gx * gy - 1) << bits) | ((1 << bits) - 1)
        assert largest < 1 << 31, (width, height)
        assert (largest << 1) | 1 < 1 << 32, (width, height)
