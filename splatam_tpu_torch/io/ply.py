"""Binary little-endian PLY export of the Gaussian splat.

Parity: scripts/export_ply.py:9-44 — same attribute layout (xyz, normals,
SH-DC colors via (rgb-0.5)/C0, opacity logit, 3 log-scales, wxyz rotation),
loadable by SuperSplat / PolyCam (README.md:188). The plyfile dependency is
replaced by a direct struct writer.

A copy of splatam_tpu/io/ply.py (numpy only), so both packages write the
same bytes for the same arrays.
"""
from __future__ import annotations

import numpy as np

C0 = 0.28209479177387814  # spherical harmonic DC constant


def rgb_to_spherical_harmonic(rgb: np.ndarray) -> np.ndarray:
    return (rgb - 0.5) / C0


def spherical_harmonic_to_rgb(sh: np.ndarray) -> np.ndarray:
    return sh * C0 + 0.5


PLY_ATTRS = [
    "x", "y", "z",
    "nx", "ny", "nz",
    "f_dc_0", "f_dc_1", "f_dc_2",
    "opacity",
    "scale_0", "scale_1", "scale_2",
    "rot_0", "rot_1", "rot_2", "rot_3",
]


def save_ply(path, means, scales, rotations, rgbs, opacities, normals=None):
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    rotations = np.asarray(rotations, np.float32)
    rgbs = np.asarray(rgbs, np.float32)
    opacities = np.asarray(opacities, np.float32).reshape(len(means), -1)
    if normals is None:
        normals = np.zeros_like(means)
    if scales.shape[1] == 1:
        scales = np.tile(scales, (1, 3))
    colors = rgb_to_spherical_harmonic(rgbs)

    data = np.concatenate(
        (means, normals, colors, opacities, scales, rotations), axis=1
    ).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(data)}"]
    header += [f"property float {a}" for a in PLY_ATTRS]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())
    print(f"Saved PLY format Splat to {path}")


def load_ply(path):
    """Read back a splat PLY written by save_ply (tests / roundtrips)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        data = np.frombuffer(f.read(n * len(PLY_ATTRS) * 4), dtype="<f4")
    data = data.reshape(n, len(PLY_ATTRS))
    return {
        "means3D": data[:, 0:3],
        "normals": data[:, 3:6],
        "rgb_colors": spherical_harmonic_to_rgb(data[:, 6:9]),
        "logit_opacities": data[:, 9:10],
        "log_scales": data[:, 10:13],
        "unnorm_rotations": data[:, 13:17],
    }
