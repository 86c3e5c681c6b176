"""Image and calibration IO on the host (port of ``utils/io.py``).

Equivalents of the reference's IO layer:
- image sequence loading by filename prefix
  (tests/matchinglib-test/io_data.cpp:218 loadImageSequence,
  :452 loadStereoSequence)
- KITTI-format calibration parsing
  (tests/poselib-test/main.cpp:82-150 loadCalibFile; sample file
  tests/poselib-test/imgs/stereo/calib_cam_to_cam.txt)

numpy only: the CLIs move the images to the card.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np

from matchinglib_poselib_torch import native


def load_image_gray(path: str | pathlib.Path) -> np.ndarray:
    """Load an image as (H, W) float32 grayscale in [0, 1].

    Decodes with the native C++ loader (``native/loader.cpp``) when
    available, falling back to PIL for encodings the native path doesn't
    cover."""
    out = native.load_image_gray(path)
    if out is not None:
        return out
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float32) / 255.0


def load_images_batch(paths, n_threads: int = 0) -> np.ndarray:
    """Decode a same-shaped image batch with the native threaded loader
    ((N, H, W) float32); per-file fallback for anything it can't decode.
    """
    paths = list(paths)
    first = load_image_gray(paths[0])
    h, w = first.shape
    out, good = native.load_batch_gray(paths, h, w, n_threads)
    if out is None or good < len(paths):
        out = np.stack([load_image_gray(p) for p in paths])
    else:
        out[0] = first
    return out


def load_stereo_sequence(
    directory: str | pathlib.Path,
    prefix_left: str = "left_",
    prefix_right: str = "right_",
):
    """Paired stereo image paths sorted by index (io_data.cpp:452)."""
    d = pathlib.Path(directory)
    lefts = sorted(d.glob(f"{prefix_left}*"))
    rights = sorted(d.glob(f"{prefix_right}*"))
    n = min(len(lefts), len(rights))
    return list(zip(lefts[:n], rights[:n]))


def load_image_sequence(directory: str | pathlib.Path, prefix: str = ""):
    """Mono image paths sorted by name (io_data.cpp:218)."""
    d = pathlib.Path(directory)
    return sorted(p for p in d.glob(f"{prefix}*") if p.suffix.lower() in
                  (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm"))


@dataclasses.dataclass
class StereoCalib:
    """KITTI raw-format stereo calibration (cam 0 = left, cam 1 = right)."""

    K0: np.ndarray  # (3, 3)
    K1: np.ndarray
    dist0: np.ndarray  # (5,) [k1 k2 p1 p2 k3]
    dist1: np.ndarray
    R: np.ndarray  # (3, 3) rotation cam0 -> cam1
    t: np.ndarray  # (3,) translation cam0 -> cam1


def load_kitti_calib(
    path: str | pathlib.Path, cam0: int = 0, cam1: int = 1
) -> StereoCalib:
    """Parse a KITTI calib_cam_to_cam.txt (poselib-test/main.cpp:82-150).

    Uses K_xx, D_xx, R_xx, T_xx entries; the relative pose cam0->cam1 is
    R = R_1 R_0^T, t = T_1 - R T_0 (the same composition the reference
    performs on the raw per-camera extrinsics).
    """
    vals: dict[str, np.ndarray] = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if ":" not in line:
            continue
        key, rest = line.split(":", 1)
        nums = re.findall(r"[-+0-9.eE]+", rest)
        try:
            vals[key.strip()] = np.array([float(x) for x in nums])
        except ValueError:
            continue

    def get(k, shape):
        return vals[k].reshape(shape)

    K0 = get(f"K_{cam0:02d}", (3, 3))
    K1 = get(f"K_{cam1:02d}", (3, 3))
    d0 = vals[f"D_{cam0:02d}"][:5]
    d1 = vals[f"D_{cam1:02d}"][:5]
    R0 = get(f"R_{cam0:02d}", (3, 3))
    R1 = get(f"R_{cam1:02d}", (3, 3))
    T0 = vals[f"T_{cam0:02d}"][:3]
    T1 = vals[f"T_{cam1:02d}"][:3]
    R = R1 @ R0.T
    t = T1 - R @ T0
    return StereoCalib(
        K0=K0.astype(np.float64),
        K1=K1.astype(np.float64),
        dist0=d0.astype(np.float64),
        dist1=d1.astype(np.float64),
        R=R.astype(np.float64),
        t=t.astype(np.float64),
    )
