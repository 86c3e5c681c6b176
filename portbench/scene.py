"""A seeded synthetic street scene and a stereo rig driving through it,
rendered on the device.

The scene of the port's smoke test (``chip_smoke._planes``, ``_render``,
``render_sequence``): a ground plane, a back wall and three slanted box
faces at 6-40 m depth, each with a 256 x 256 texture of uniform grey
cells, ray-cast into a camera with KITTI's intrinsics at 1392 x 512; the
right camera sits at the planted rig X2 = R X1 + t (0.54 m baseline,
~1.5 deg rotation). Rewritten in PyTorch so that a sequence renders on
the card in a fraction of a second: the textures and the pixel noise come
from a ``torch.Generator`` there, so a seed gives the same frames on every
run of one machine, not the numpy version's frames.
"""

from __future__ import annotations

import math

import torch

WIDTH, HEIGHT = 1392, 512
K_FULL = ((980.0, 0.0, 690.0), (0.0, 975.0, 247.0), (0.0, 0.0, 1.0))
RIG_AXIS, RIG_DEG = (0.15, 1.0, 0.1), 1.5
RIG_T = (-0.54, 0.01, 0.04)
TEXTURE = 256
# (origin, axis a, axis b, u range, v range, cell m)
PLANES = (
    ((0.0, 1.65, 0.0), (1, 0, 0), (0, 0, 1), (-40, 40), (1.0, 80), 0.10),
    ((0.0, 0.0, 40.0), (1, 0, 0), (0, 1, 0), (-80, 80), (-40, 1.65), 0.30),
    ((-2.6, 0.3, 9.0), (0.87, 0, 0.5), (0, 1, 0), (-1.6, 1.6), (-1.6, 1.35),
     0.07),
    ((2.8, 0.5, 14.0), (0.9, 0, -0.43), (0, 1, 0), (-1.8, 1.8), (-1.8, 1.15),
     0.09),
    ((0.7, -0.3, 6.5), (1, 0, 0.25), (0, 0.95, 0.3), (-0.9, 0.9),
     (-0.7, 0.7), 0.05),
)
_F64 = torch.float64


def rot(axis, deg, device="cpu") -> torch.Tensor:
    """Rotation by `deg` degrees about `axis` (Rodrigues), float64."""
    a = torch.tensor(axis, dtype=_F64, device=device)
    a = a / torch.linalg.norm(a)
    K = torch.tensor([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                      [-a[1], a[0], 0.0]], dtype=_F64, device=device)
    r = math.radians(deg)
    return (torch.eye(3, dtype=_F64, device=device) + math.sin(r) * K
            + (1 - math.cos(r)) * K @ K)


def intrinsics(width: int = WIDTH, height: int = HEIGHT,
               device="cpu") -> torch.Tensor:
    K = torch.tensor(K_FULL, dtype=_F64, device=device)
    K[0] *= width / WIDTH
    K[1] *= height / HEIGHT
    return K


def rig(device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The planted relative pose (R, t) of the right camera."""
    return rot(RIG_AXIS, RIG_DEG, device), torch.tensor(
        RIG_T, dtype=_F64, device=device)


def planes(g: torch.Generator, device) -> list:
    """The scene's planes: (p0, a, b, n, u range, v range, cell, texture),
    textures uniform in [0.08, 0.92] from `g`."""
    out = []
    for p0, a, b, ur, vr, cell in PLANES:
        a = torch.tensor(a, dtype=_F64, device=device)
        b = torch.tensor(b, dtype=_F64, device=device)
        a, b = a / torch.linalg.norm(a), b / torch.linalg.norm(b)
        tex = 0.08 + 0.84 * torch.rand(TEXTURE, TEXTURE, generator=g,
                                       device=device, dtype=_F64)
        out.append((torch.tensor(p0, dtype=_F64, device=device), a, b,
                    torch.linalg.cross(a, b), ur, vr, cell, tex))
    return out


def render(scene: list, K, R, t, width: int, height: int) -> torch.Tensor:
    """Ray-cast the planes into camera [R|t] (X_cam = R X + t), one sample
    per pixel centre, no noise: (height, width) float64."""
    dev = K.device
    v, u = torch.meshgrid(torch.arange(height, dtype=_F64, device=dev),
                          torch.arange(width, dtype=_F64, device=dev),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d = pix @ torch.linalg.inv(K).T @ R  # ray directions in the world
    origin = -R.T @ t
    best = torch.full((d.shape[0],), math.inf, dtype=_F64, device=dev)
    val = torch.full((d.shape[0],), 0.5, dtype=_F64, device=dev)
    for p0, a, b, n, ur, vr, cell, tex in scene:
        lam = ((p0 - origin) @ n) / (d @ n)  # parallel rays: inf / nan
        X = origin + lam[:, None] * d
        pu = (X - p0) @ a
        pv = (X - p0) @ b
        hit = ((lam > 0) & (lam < best) & (pu >= ur[0]) & (pu <= ur[1])
               & (pv >= vr[0]) & (pv <= vr[1]))
        iu = torch.remainder(torch.floor(pu / cell), TEXTURE)
        iv = torch.remainder(torch.floor(pv / cell), TEXTURE)
        tv = tex[torch.nan_to_num(iv).long().clamp(0, TEXTURE - 1),
                 torch.nan_to_num(iu).long().clamp(0, TEXTURE - 1)]
        best = torch.where(hit, lam, best)
        val = torch.where(hit, tv, val)
    return val.reshape(height, width)


def camera(frame: int, lap_frames: int, lap_offsets) -> tuple:
    """Camera 1's pose at `frame`: 0.25 m forward and 0.2 deg of yaw per
    frame, as the smoke test's sequence drives, in laps of `lap_frames`
    frames, each lap from its own lateral offset (m), so that the rig
    never reaches the box faces 6.3 m ahead."""
    lap, k = divmod(frame, lap_frames)
    R1 = rot((0.0, 1.0, 0.0), 0.2 * k)
    centre = torch.tensor([lap_offsets[lap % len(lap_offsets)], 0.0,
                           0.25 * k], dtype=_F64)
    return R1, -R1 @ centre


def sequence(g: torch.Generator, frames: int, device, lap_frames: int,
             lap_offsets, noise: float, width: int = WIDTH,
             height: int = HEIGHT):
    """(imgs1, imgs2) (frames, height, width) float32 in [0, 1]: the
    rig's left and right images at each frame, with Gaussian pixel noise
    of std `noise`; and K, float32."""
    scene = planes(g, device)
    K = intrinsics(width, height, device)
    R, t = rig(device)
    imgs1 = torch.empty((frames, height, width), device=device)
    imgs2 = torch.empty_like(imgs1)
    for f in range(frames):
        R1, t1 = (x.to(device) for x in camera(f, lap_frames, lap_offsets))
        for out, (Rc, tc) in ((imgs1, (R1, t1)), (imgs2, (R @ R1, R @ t1 + t))):
            img = render(scene, K, Rc, tc, width, height)
            img = img + noise * torch.randn(img.shape, generator=g,
                                            device=device, dtype=_F64)
            out[f] = img.clamp(0.0, 1.0).to(torch.float32)
    return imgs1, imgs2, K.to(torch.float32)
