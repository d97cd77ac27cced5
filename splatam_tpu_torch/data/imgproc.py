"""The image operations the loaders take from cv2, in numpy, with cv2's
semantics (the reference package resizes and undistorts through cv2,
which the GPU machine does not install).

resize_linear   cv2.resize(..., INTER_LINEAR): half-pixel-centred
                bilinear, source coordinates clamped to the image (an exact
                2x reduction, which cv2 routes to INTER_AREA, is the same
                2x2 average)
resize_nearest  cv2.resize(..., INTER_NEAREST): src = min(floor(dst *
                in/out), in - 1)
undistort       cv2.undistort(img, K, [k1, k2, p1, p2, k3]): each output
                pixel samples the forward-distorted source point, which cv2
                rounds to 1/32 pixel, bilinearly with a zero border

All take float arrays [H, W] or [H, W, C] and compute in float64.
"""
from __future__ import annotations

import numpy as np

_TAB = 32  # cv2's INTER_TAB_SIZE: remap's subpixel grid


def _linear_taps(n_in: int, n_out: int):
    """(i0, i1, w0, w1) along one axis: cv2's source index and weights for
    each output index."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[(i0 < 0) | (i0 >= n_in - 1)] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), 1.0 - f, f


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    if h == 2 * height and w == 2 * width:
        # cv2 takes INTER_AREA here: the mean of each 2x2 block.
        return (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]) * 0.25
    along_x = (slice(None),) + (None,) * (img.ndim - 2)
    along_y = (slice(None),) + (None,) * (img.ndim - 1)
    x0, x1, wx0, wx1 = _linear_taps(w, width)
    rows = img[:, x0] * wx0[along_x] + img[:, x1] * wx1[along_x]
    y0, y1, wy0, wy1 = _linear_taps(h, height)
    return rows[y0] * wy0[along_y] + rows[y1] * wy1[along_y]


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    img = np.asarray(img)
    h, w = img.shape[:2]

    def src(n_in, n_out):
        step = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * step).astype(np.int64), n_in - 1)

    return img[src(h, height)][:, src(w, width)]


def _inverse_camera(fx: float, fy: float, cx: float, cy: float):
    """cv2's closed-form inverse of [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
    (cv::invert for 3x3): (ir0, ir2, ir4, ir5)."""
    d = 1.0 / (fx * fy)
    return fy * d, -(cx * fy) * d, fx * d, -(fx * cy) * d


def undistort(img: np.ndarray, k: np.ndarray, dist) -> np.ndarray:
    """cv2.undistort with the new camera matrix equal to k: the map is
    built in stripes of rows as cv2 builds it, then sampled."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape[:2]
    fx, fy, cx, cy = float(k[0][0]), float(k[1][1]), float(k[0][2]), float(k[1][2])
    d = [float(v) for v in np.asarray(dist, np.float64).reshape(-1)] + [0.0] * 5
    k1, k2, p1, p2, k3 = d[:5]
    if any(d[5:]):
        raise ValueError("undistort: only k1, k2, p1, p2, k3 are supported")
    stripe = min(max(1, (1 << 12) // max(w, 1)), h)
    iu = np.empty((h, w), np.int64)
    iv = np.empty((h, w), np.int64)
    for y0 in range(0, h, stripe):
        n = min(stripe, h - y0)
        ir0, ir2, ir4, ir5 = _inverse_camera(fx, fy, cx, cy - y0)
        # x advances by ir0 per column, accumulated as cv2 accumulates it.
        xs = np.cumsum(np.concatenate([[ir2], np.full(w - 1, ir0)]))
        ys = np.arange(n)[:, None] * ir4 + ir5
        x, y = np.broadcast_to(xs, (n, w)), np.broadcast_to(ys, (n, w))
        x2, y2 = x * x, y * y
        r2, xy2 = x2 + y2, 2 * x * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        u = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx
        v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy
        iu[y0: y0 + n] = np.rint(u * _TAB).astype(np.int64)
        iv[y0: y0 + n] = np.rint(v * _TAB).astype(np.int64)
    sx, sy = iu >> 5, iv >> 5
    ax, ay = (iu & (_TAB - 1)) / _TAB, (iv & (_TAB - 1)) / _TAB
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], np.float64)
    pad[1:-1, 1:-1] = img
    outside = (sx < -1) | (sx >= w) | (sy < -1) | (sy >= h)
    px, py = np.clip(sx + 1, 0, w), np.clip(sy + 1, 0, h)
    extra = (...,) + (None,) * (img.ndim - 2)
    w00, w01 = ((1 - ax) * (1 - ay))[extra], (ax * (1 - ay))[extra]
    w10, w11 = ((1 - ax) * ay)[extra], (ax * ay)[extra]
    out = (pad[py, px] * w00 + pad[py, px + 1] * w01
           + pad[py + 1, px] * w10 + pad[py + 1, px + 1] * w11)
    out[outside] = 0.0
    return out
