"""Shared helpers of the PyTorch-port parity tests (no tests of its own).

The parity tests feed the same numpy inputs, made from a seed, to a JAX
function of ``matchinglib_poselib_tpu`` and to its counterpart in
``matchinglib_poselib_torch``, and compare the outputs as numpy arrays.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

# xdist runs several workers per host: keep each worker's torch pool small
torch.set_num_threads(2)


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (float32 unless given)."""
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out if dtype is None else out.to(dtype)


def j(x, dtype=jnp.float32):
    """numpy array -> JAX array."""
    return jnp.asarray(np.asarray(x), dtype)


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words_u32_to_i32(d):
    """JAX (N, W) uint32 descriptor words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(d, np.uint32).view(np.int32).copy())


def jax_uniforms(key, batches: int, B: int, k: int):
    """The uniforms the JAX ``ransac`` draws for batches 0..batches-1:
    ``uniform(fold_in(key, i), (B, k))``, stacked -> (batches, B, k)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (B, k)))
        for i in range(batches)
    ]))


def jax_degen_uniforms(key, B: int):
    """Uniforms of the degeneracy check's single homography batch: the
    JAX package runs it under fold_in(key, 777), batch 0."""
    kd = jax.random.fold_in(key, 777)
    return jax_uniforms(kd, 1, min(B, 64), 4)


def rot_angle_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees (float64)."""
    dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def dir_angle_deg(a, b):
    """Angle between two direction vectors in degrees (float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def textured_image(rng, h=240, w=320):
    """Smooth random texture with corners (as tests/test_features.py)."""
    img = rng.normal(size=(h // 4, w // 4)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))
    for _ in range(2):
        img = 0.25 * (
            np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        )
    return (img - img.min()) / (img.max() - img.min())


def align_slots(jxy, jmask, txy, tmask, tol=1e-4):
    """For every JAX keypoint slot, the port slot holding the keypoint at
    the same position (max-norm distance <= tol), or -1 (also for masked
    JAX slots). Scale-space detectors can find an extremum on an f32 near
    tie on one side only, which shifts every later slot; aligning by
    position compares the rest slot for slot again."""
    jxy = np.asarray(jxy, np.float64)
    txy = np.asarray(txy, np.float64)
    d = np.abs(jxy[:, None, :] - txy[None, :, :]).max(-1)
    d[~np.asarray(jmask, bool)] = np.inf
    d[:, ~np.asarray(tmask, bool)] = np.inf
    best = d.argmin(1)
    ok = d[np.arange(len(best)), best] <= tol
    return np.where(ok, best, -1)


def aligned_fraction(perm, jmask, tmask):
    """Share of the keypoints valid on either side that the other side
    holds at the same position, and the number that it misses."""
    jmask, tmask = np.asarray(jmask, bool), np.asarray(tmask, bool)
    both = int((perm >= 0).sum())
    union = int(jmask.sum() + tmask.sum()) - both
    return both / max(union, 1), union - both
