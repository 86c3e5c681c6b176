"""The device renderer draws the smoke test's scene as its numpy version
does, before noise."""

import numpy as np
import torch

import chip_smoke
from portbench import scene


def test_render_matches_the_numpy_geometry():
    w, h = 116, 43  # KITTI's 1392 x 512 over 12
    rng = np.random.default_rng(3)
    planes_np = chip_smoke._planes(rng)
    K = chip_smoke.K_FULL.copy()
    K[0] *= w / chip_smoke.WIDTH
    K[1] *= h / chip_smoke.HEIGHT
    R1 = chip_smoke._rot((0.0, 1.0, 0.0), 0.6)
    t1 = -R1 @ np.array([0.0, 0.0, 0.75])
    R, t = chip_smoke._rot((0.15, 1.0, 0.1), 1.5), np.array([-0.54, 0.01,
                                                               0.04])
    f64 = torch.float64
    planes_t = [tuple(torch.tensor(x, dtype=f64) if isinstance(x, np.ndarray)
                      else x for x in p[:4]) + tuple(p[4:7])
                + (torch.tensor(p[7], dtype=f64),) for p in planes_np]
    Kt = scene.intrinsics(w, h)
    assert torch.allclose(Kt, torch.tensor(K))
    Rs, ts = scene.rig()
    assert torch.allclose(Rs, torch.tensor(R), atol=1e-15)
    R1s, t1s = scene.camera(3, 20, [0.0])
    assert torch.allclose(R1s, torch.tensor(R1), atol=1e-15)
    assert torch.allclose(t1s, torch.tensor(t1), atol=1e-15)
    for Rc, tc in ((R1, t1), (R @ R1, R @ t1 + t)):
        want = chip_smoke._render(planes_np, K, Rc, tc, w, h,
                                  np.random.default_rng(0), 0.0, ss=1)
        got = scene.render(planes_t, torch.tensor(K), torch.tensor(Rc),
                           torch.tensor(tc), w, h).to(torch.float32).numpy()
        assert np.mean(got == want) >= 0.999


def test_sequence_is_seeded_and_in_range():
    g = torch.Generator().manual_seed(11)
    a1, a2, K = scene.sequence(g, 3, "cpu", 2, [0.0, 0.3], 0.005, 116, 43)
    g = torch.Generator().manual_seed(11)
    b1, b2, _ = scene.sequence(g, 3, "cpu", 2, [0.0, 0.3], 0.005, 116, 43)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert a1.shape == (3, 43, 116) and a1.dtype == torch.float32
    assert float(a1.min()) >= 0.0 and float(a1.max()) <= 1.0
    assert not torch.equal(a1[0], a1[1])  # every frame its own pose
