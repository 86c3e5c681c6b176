"""Match / rectification visualization writers on the host (port of
``utils/visualize.py``).

Equivalents of the reference's display+store helpers, headless:
- ``draw_matches`` + ``write_png``: the side-by-side match image the
  reference shows and stores (showMatches, matchinglib-test/main.cpp:84,
  cv::drawMatches) — keypoint circles, match lines, optional cap on the
  number of drawn matches (the reference's ``--showNr``).
- ``draw_rectified_pair``: the horizontally-stacked rectified pair with
  epipolar scan lines the reference displays for visual verification
  (ShowRectifiedImages, pose_helper.cpp:2636).

Pure numpy + a from-scratch PNG encoder (zlib, filter 0) so no display
or OpenCV dependency exists anywhere in the package.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

# distinct, bright line colors cycled over matches (RGB)
_COLORS = np.array(
    [
        (66, 203, 92),
        (255, 196, 40),
        (80, 160, 255),
        (240, 90, 90),
        (200, 110, 240),
        (70, 220, 210),
        (250, 140, 40),
        (160, 220, 70),
    ],
    np.uint8,
)


def write_png(path: str | pathlib.Path, img: np.ndarray) -> None:
    """Write (H, W) grayscale or (H, W, 3) RGB uint8 as a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        color_type, arr = 0, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, arr = 2, img
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = arr.shape[:2]
    raw = b"".join(
        b"\x00" + arr[y].tobytes() for y in range(h)
    )  # filter 0 per scanline

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    pathlib.Path(path).write_bytes(payload)


def _to_u8_rgb(img: np.ndarray) -> np.ndarray:
    """float [0,1] or uint8 grayscale -> (H, W, 3) uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def _draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    """Anti-alias-free line via dense parametric sampling (host-side)."""
    h, w = canvas.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def _draw_circle(canvas: np.ndarray, center, radius: int, color) -> None:
    h, w = canvas.shape[:2]
    th = np.linspace(0.0, 2 * np.pi, 8 * radius + 8)
    xs = (center[0] + radius * np.cos(th)).round().astype(int)
    ys = (center[1] + radius * np.sin(th)).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def draw_matches(
    img1: np.ndarray,
    pts1: np.ndarray,
    img2: np.ndarray,
    pts2: np.ndarray,
    mask: np.ndarray | None = None,
    max_draw: int = 50,
    radius: int = 3,
) -> np.ndarray:
    """Side-by-side match image (cv::drawMatches semantics).

    ``max_draw`` mirrors the reference's ``--showNr`` (default 50;
    <= 0 draws every match). When more matches exist than ``max_draw``,
    an evenly-spaced subset is drawn, like the reference's stride
    selection. Returns (H, W1+W2, 3) uint8.
    """
    a = _to_u8_rgb(img1)
    b = _to_u8_rgb(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]

    pts1 = np.asarray(pts1, np.float64)
    pts2 = np.asarray(pts2, np.float64)
    if mask is not None:
        keep = np.asarray(mask).astype(bool)
        pts1, pts2 = pts1[keep], pts2[keep]
    n = len(pts1)
    if n == 0:
        return canvas
    if max_draw > 0 and n > max_draw:
        sel = np.linspace(0, n - 1, max_draw).round().astype(int)
        pts1, pts2 = pts1[sel], pts2[sel]
    for i, (p, q) in enumerate(zip(pts1, pts2)):
        c = _COLORS[i % len(_COLORS)]
        q_off = (q[0] + off, q[1])
        _draw_circle(canvas, p, radius, c)
        _draw_circle(canvas, q_off, radius, c)
        _draw_line(canvas, p, q_off, c)
    return canvas


def draw_rectified_pair(
    rect1: np.ndarray, rect2: np.ndarray, line_step: int = 32
) -> np.ndarray:
    """Stacked rectified pair with horizontal scan lines.

    The headless counterpart of ShowRectifiedImages
    (pose_helper.cpp:2636): on a correctly rectified pair every drawn
    line passes through corresponding scene points in both halves.
    """
    a = _to_u8_rgb(rect1)
    b = _to_u8_rgb(rect2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    canvas[line_step::line_step, :] = (66, 203, 92)
    return canvas
