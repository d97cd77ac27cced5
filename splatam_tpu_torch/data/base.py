"""Host-side RGB-D dataset base class (numpy).

Counterpart of splatam_tpu/data/base.py (reference:
datasets/gradslam_datasets/basedataset.py). __getitem__ returns numpy
float32 arrays with the reference's conventions:
    color      [H, W, 3]  float32, 0-255 (NOT normalized)
    depth      [H, W, 1]  float32, meters (png value / png_depth_scale)
    intrinsics [4, 4]     float32 (3x3 K embedded, scaled for resize)
    pose       [4, 4]     float32 c2w, relative to frame 0 when
                          relative_pose=True
Color is resized bilinearly and depth by nearest neighbour with cv2's rules
(data/imgproc.py), and colour is undistorted where the camera has a
`distortion` key. Images are read through Pillow where it imports (the
plugin the reference's imageio goes through for PNG and JPEG), else a PNG
through data/png.py's read_png; a JPEG without Pillow raises.
"""
from __future__ import annotations

import re

import numpy as np

from splatam_tpu_torch.data import imgproc
from splatam_tpu_torch.data.png import read_png


def natsorted(items):
    """Natural sort (replacement for the natsort dependency)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    k = np.eye(3)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = intrinsics
    return k


def scale_intrinsics(k: np.ndarray, h_ratio: float, w_ratio: float) -> np.ndarray:
    """datautils.scale_intrinsics semantics."""
    k = k.astype(np.float32).copy()
    k[..., 0, 0] *= w_ratio
    k[..., 0, 2] *= w_ratio
    k[..., 1, 1] *= h_ratio
    k[..., 1, 2] *= h_ratio
    return k


def relative_transformation_np(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """t1^-1 @ t2 for rigid transforms (geometryutils.relative_transformation)."""
    rot = t1[:3, :3].T
    trans = -rot @ t1[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = rot @ t2[:3, :3]
    out[:3, 3] = rot @ t2[:3, 3] + trans
    return out


def readEXR_onlydepth(filename):
    import Imath
    import OpenEXR as exr

    exrfile = exr.InputFile(filename)
    header = exrfile.header()
    dw = header["dataWindow"]
    isize = (dw.max.y - dw.min.y + 1, dw.max.x - dw.min.x + 1)
    channel_data = {}
    for c in header["channels"]:
        cdat = exrfile.channel(c, Imath.PixelType(Imath.PixelType.FLOAT))
        channel_data[c] = np.reshape(np.frombuffer(cdat, dtype=np.float32), isize)
    return channel_data.get("Y")


class ImageReader:
    """Reads an image file into the array imageio.v2.imread gives: Pillow
    where it imports, else read_png for a PNG. Says once, at construction,
    which it uses."""

    def __init__(self):
        try:
            from PIL import Image
        except ImportError:
            self._pil = None
            print("[splatam-torch] images: Pillow is not installed; PNGs are read by "
                  "data/png.py's read_png, other formats cannot be read")
        else:
            self._pil = Image
            print(f"[splatam-torch] images: Pillow {Image.__version__}")

    @property
    def name(self) -> str:
        return "Pillow" if self._pil is not None else "read_png"

    def __call__(self, path: str) -> np.ndarray:
        if self._pil is not None:
            with self._pil.open(path) as im:
                return np.asarray(im)
        if str(path).lower().endswith(".png"):
            return read_png(path)
        raise RuntimeError(f"{path}: reading this format needs Pillow, which is not "
                           "installed (read_png reads PNG only)")


class GradSLAMDataset:
    def __init__(
        self,
        config_dict,
        stride: int | None = 1,
        start: int = 0,
        end: int = -1,
        desired_height: int = 480,
        desired_width: int = 640,
        channels_first: bool = False,
        normalize_color: bool = False,
        device=None,  # accepted for API parity; ignored (host arrays)
        dtype=np.float32,
        load_embeddings: bool = False,
        embedding_dir: str = "feat_lseg_240_320",
        embedding_dim: int = 512,
        relative_pose: bool = True,
        **kwargs,
    ):
        self.name = config_dict["dataset_name"]
        self.png_depth_scale = config_dict["camera_params"]["png_depth_scale"]
        self.orig_height = config_dict["camera_params"]["image_height"]
        self.orig_width = config_dict["camera_params"]["image_width"]
        self.fx = config_dict["camera_params"]["fx"]
        self.fy = config_dict["camera_params"]["fy"]
        self.cx = config_dict["camera_params"]["cx"]
        self.cy = config_dict["camera_params"]["cy"]

        self.dtype = dtype
        self.desired_height = desired_height
        self.desired_width = desired_width
        self.height_downsample_ratio = float(desired_height) / self.orig_height
        self.width_downsample_ratio = float(desired_width) / self.orig_width
        self.channels_first = channels_first
        self.normalize_color = normalize_color
        self.load_embeddings = load_embeddings
        self.embedding_dir = embedding_dir
        self.embedding_dim = embedding_dim
        self.relative_pose = relative_pose

        self.start = start
        self.end = end
        if start < 0:
            raise ValueError(f"start must be positive. Got {start}.")
        if not (end == -1 or end > start):
            raise ValueError(f"end ({end}) must be -1 or greater than start ({start})")

        cam = config_dict["camera_params"]
        self.distortion = np.array(cam["distortion"]) if "distortion" in cam else None
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam.get("crop_edge")
        self.imread = ImageReader()

        self.color_paths, self.depth_paths, self.embedding_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("Number of color and depth images must be the same.")
        self.num_imgs = len(self.color_paths)
        self.poses = self.load_poses()

        if self.end == -1:
            self.end = self.num_imgs

        sl = slice(self.start, self.end, stride)
        self.color_paths = self.color_paths[sl]
        self.depth_paths = self.depth_paths[sl]
        if self.load_embeddings and self.embedding_paths is not None:
            self.embedding_paths = self.embedding_paths[sl]
        self.poses = self.poses[sl]
        self.retained_inds = np.arange(self.num_imgs)[sl]
        self.num_imgs = len(self.color_paths)

        self.poses = np.stack([np.asarray(p, np.float64) for p in self.poses])
        if self.relative_pose:
            self.transformed_poses = np.stack(
                [relative_transformation_np(self.poses[0], p) for p in self.poses]
            )
        else:
            self.transformed_poses = self.poses

    def __len__(self):
        return self.num_imgs

    def get_filepaths(self):
        raise NotImplementedError

    def load_poses(self):
        raise NotImplementedError

    def _preprocess_color(self, color: np.ndarray) -> np.ndarray:
        color = imgproc.resize_linear(color, self.desired_height, self.desired_width)
        if self.normalize_color:
            color = color / 255.0
        if self.channels_first:
            color = np.ascontiguousarray(color.transpose(2, 0, 1))
        return color

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        depth = imgproc.resize_nearest(depth.astype(float), self.desired_height,
                                       self.desired_width)
        depth = np.expand_dims(depth, -1)
        if self.channels_first:
            depth = np.ascontiguousarray(depth.transpose(2, 0, 1))
        return depth / self.png_depth_scale

    def get_cam_K(self) -> np.ndarray:
        return as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])

    def __getitem__(self, index):
        color_path = self.color_paths[index]
        depth_path = self.depth_paths[index]
        color = np.asarray(self.imread(color_path), dtype=float)
        color = self._preprocess_color(color)
        if str(depth_path).endswith(".exr"):
            depth = readEXR_onlydepth(depth_path)
        elif str(depth_path).endswith(".npy"):
            depth = np.load(depth_path)
        else:
            depth = np.asarray(self.imread(depth_path), dtype=np.int64)

        k = as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])
        if self.distortion is not None:
            color = imgproc.undistort(color, k, self.distortion)

        depth = self._preprocess_depth(depth)
        k = scale_intrinsics(k, self.height_downsample_ratio, self.width_downsample_ratio)
        intrinsics = np.eye(4, dtype=np.float32)
        intrinsics[:3, :3] = k

        pose = self.transformed_poses[index]
        return (
            color.astype(self.dtype),
            depth.astype(self.dtype),
            intrinsics.astype(self.dtype),
            pose.astype(self.dtype),
        )

