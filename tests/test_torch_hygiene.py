"""Port hygiene: no jax at run time, plain versions on the CPU, and (with a
CUDA card) each kernel equal to its plain version."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from matchinglib_poselib_torch.ops import kernels
from matchinglib_poselib_torch.ops.kernels import fast_nms, knn2

from test_torch_helpers import textured_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_runs_without_importing_jax():
    """A fresh interpreter imports the port and chip_smoke, runs the plain
    pipeline at the FAST/ORB and the SIFT/SIFT + GMS configs, and never
    imports jax."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, torch
        import chip_smoke
        from matchinglib_poselib_torch import config as c
        from matchinglib_poselib_torch.models import pipeline
        img1, img2, K, _, _ = chip_smoke.render_scene(0, 192, 96)
        pipe = pipeline.StereoPipeline(
            c.DetectorConfig(max_keypoints=64, fast_threshold=12.0,
                             column_bands=4),
            pose_cfg=c.PoseConfig(
                robust=c.RobustConfig(batch_hypotheses=8, max_batches=2)),
            device="cpu")
        corr, pose = pipe.run(torch.tensor(img1), torch.tensor(img2),
                              torch.tensor(K), torch.tensor(K),
                              torch.zeros(5), torch.zeros(5),
                              torch.Generator().manual_seed(0))
        assert pose.R.shape == (3, 3) and bool(torch.isfinite(pose.R).all())
        pipe = pipeline.StereoPipeline(
            c.DetectorConfig(kind="SIFT", max_keypoints=64),
            c.DescriptorConfig(kind="SIFT"),
            c.MatchingConfig(gms_filter=True),
            c.PoseConfig(robust=c.RobustConfig(batch_hypotheses=8,
                                               max_batches=2)),
            device="cpu")
        corr, pose = pipe.run(img1, img2, K, K, np.zeros(5), np.zeros(5),
                              torch.Generator().manual_seed(0))
        assert corr.kps1.xy.shape == (64, 2)
        assert bool(torch.isfinite(pose.R).all())
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m.startswith("matchinglib_poselib_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(textured_image(rng, 64, 96))[None]
    out = fast_nms.fast_nms_score(img, 12.0 / 255.0, 3)
    assert torch.equal(out, fast_nms.fast_nms_score_plain(img, 12.0 / 255.0,
                                                          3))
    d1 = torch.from_numpy(rng.integers(-2**31, 2**31, (40, 8),
                                       dtype=np.int64).astype(np.int32))
    d2 = torch.from_numpy(rng.integers(-2**31, 2**31, (50, 8),
                                       dtype=np.int64).astype(np.int32))
    valid = torch.ones(50, dtype=torch.bool)
    for a, b in zip(knn2.knn2(d1, d2, valid), knn2.knn2_plain(d1, d2, valid)):
        assert torch.equal(a, b)
    f1 = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(50, 64)).astype(np.float32))
    for a, b in zip(knn2.knn2_l2(f1, f2, valid),
                    knn2.knn2_l2_plain(f1, f2, valid)):
        assert torch.equal(a, b)
    assert kernels.launch_counts() == {"fast_nms": 0, "knn2": 0,
                                       "knn2_l2": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        knn2.knn2(torch.zeros(4, 8, dtype=torch.int32),
                  torch.zeros(4, 8, dtype=torch.int32),
                  torch.ones(4, dtype=torch.bool), xy_mode=3)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score(torch.zeros(2, 8, 8, device="meta"), 0.1, 3)
    f = torch.zeros(6, 16)
    ok = torch.ones(6, dtype=torch.bool)
    for bad in (
        dict(desc1=f.double()),  # f64
        dict(desc2=torch.zeros(16, 6).T),  # not contiguous
        dict(xy_mode=3),
        dict(desc2=torch.zeros(6, 15)),  # depth mismatch
        dict(xy_mode=1),  # gate inputs missing
    ):
        kw = dict(desc1=f, desc2=f, valid2=ok) | bad
        with pytest.raises(ValueError):
            knn2.knn2_l2(**kw)
    with pytest.raises(ValueError):
        knn2.knn2_l2(f.to("meta"), f.to("meta"), ok.to("meta"))


@pytest.mark.gpu
def test_kernels_equal_plain_on_the_card():
    """Run on a CUDA card (chip_smoke.py drives the same checks at the
    main path's shapes): FAST+NMS equal to plain away from the border,
    2-NN bit-exact for every xy_mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(np.stack([textured_image(rng, 96, 200)
                                      for _ in range(2)])).cuda()
    out = fast_nms.fast_nms_score(imgs, 12.0 / 255.0, 3)
    ref = fast_nms.fast_nms_score_plain(imgs, 12.0 / 255.0, 3)
    assert torch.equal(out[:, 16:-16, 16:-16], ref[:, 16:-16, 16:-16])
    n1, n2 = 300, 500
    d1 = torch.from_numpy(rng.integers(-2**31, 2**31, (n1, 8),
                                       dtype=np.int64).astype(np.int32))
    d2 = torch.from_numpy(rng.integers(-2**31, 2**31, (n2, 8),
                                       dtype=np.int64).astype(np.int32))
    valid2 = torch.from_numpy(rng.random(n2) > 0.1)
    pred = torch.from_numpy(rng.uniform(0, 100, (n1, 2)).astype(np.float32))
    pts2 = torch.from_numpy(rng.uniform(0, 100, (n2, 2)).astype(np.float32))
    for mode in (0, 1, 2):
        rad2 = torch.full((n1 if mode == 1 else n2,), 900.0)
        args = (d1, d2, valid2) + ((pred, rad2, pts2) if mode else ())
        got = knn2.knn2(*(a.cuda() for a in args), xy_mode=mode)
        want = knn2.knn2_plain(*args, xy_mode=mode)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    # float 2-NN (K2b): the tolerance of tests/test_torch_matching.py
    for depth in (128, 67):
        f1 = torch.from_numpy(rng.normal(size=(n1, depth)).astype(np.float32))
        f2 = torch.from_numpy(rng.normal(size=(n2, depth)).astype(np.float32))
        f1 = f1 / f1.norm(dim=1, keepdim=True)
        f2 = f2 / f2.norm(dim=1, keepdim=True)
        f2[17] = f2[11] = f1[5]  # planted duplicates: lowest index wins
        valid2[17] = valid2[11] = True
        for mode in (0, 1, 2):
            rad2 = torch.full((n1 if mode == 1 else n2,), 1e8)
            args = (f1, f2, valid2) + ((pred, rad2, pts2) if mode else ())
            gd, gs, gi = (g.cpu() for g in knn2.knn2_l2(
                *(a.cuda() for a in args), xy_mode=mode))
            wd, ws, wi = knn2.knn2_l2_plain(*args, xy_mode=mode)
            assert bool(((gd - wd).abs() <= 1e-5 * (1 + wd.abs())).all())
            assert bool(((gs - ws).abs() <= 1e-5 * (1 + ws.abs())).all())
            gap = (ws - wd) > 1e-5
            assert torch.equal(gi[gap], wi[gap])
            assert int(gi[5]) == 11 and float(gs[5]) == float(gd[5])
