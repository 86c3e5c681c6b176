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
    pipeline at the FAST/ORB and the SIFT/SIFT + GMS configs, run_batch on
    two small pairs, one estimate_pose per pose branch (AutoTh, Halign,
    BA, Kneip), two frames
    of StereoRefine at chip_smoke's stream config (a small pool) with a
    checkpoint round trip, and the FileStorage readers, and never imports
    jax."""
    code = textwrap.dedent("""
        import dataclasses, sys
        import numpy as np, torch
        import chip_smoke
        from matchinglib_poselib_torch import config as c
        from matchinglib_poselib_torch.models import pipeline
        from matchinglib_poselib_torch.ops import ba, eigensolver
        from matchinglib_poselib_torch.ops import homography_pose, robust
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
        img3, img4, _, _, _ = chip_smoke.render_scene(1, 192, 96)
        corr, pose = pipe.run_batch(np.stack([img1, img3]),
                                    np.stack([img2, img4]), K, K,
                                    np.zeros(5), np.zeros(5),
                                    torch.Generator().manual_seed(0))
        assert pose.R.shape == (2, 3, 3) and corr.mask.shape == (2, 64)
        assert bool(torch.isfinite(pose.R).all())
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
        base = c.PoseConfig(robust=c.RobustConfig(batch_hypotheses=8,
                                                  max_batches=2))
        Kt = torch.tensor(K)
        for i, (name, change, _) in enumerate(chip_smoke.pose_menu(c)):
            cfg = dataclasses.replace(base, **change)
            pose = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality, Kt, Kt,
                torch.zeros(5), torch.zeros(5), cfg,
                **chip_smoke.pose_streams(torch, robust, cfg, i))
            assert bool(torch.isfinite(pose.R).all()), name
        import os, tempfile
        from matchinglib_poselib_torch.models import checkpoint
        from matchinglib_poselib_torch.models.stereo_refine import (
            StereoRefine)
        from matchinglib_poselib_torch.ops import pool
        from matchinglib_poselib_torch.utils import opencv_fs
        sr_cfg = chip_smoke.stereo_ref_config(c)
        sr_cfg = dataclasses.replace(
            sr_cfg, max_pool_correspondences=256,
            pose=dataclasses.replace(sr_cfg.pose, robust=base.robust))
        def new_sr():
            return StereoRefine(K, K, cfg=sr_cfg, device="cpu",
                                streams=chip_smoke.SeededStreams(
                                    torch, base.robust, 0))
        sr = new_sr()
        for _ in range(2):
            fr = sr.add_new_correspondences(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                desc_dist=corr.distance)
            assert np.isfinite(fr.R).all() and fr.pool_size <= 256
        path = os.path.join(tempfile.mkdtemp(), "sr.npz")
        checkpoint.save_stereo_refine(sr, path)
        back = new_sr()
        checkpoint.load_stereo_refine(back, path)
        assert int(back.pool.n_valid) == int(sr.pool.n_valid)
        assert isinstance(back.pool, pool.Pool)
        fs = "eval/fixtures/semireal_fs/"
        frame = opencv_fs.sequ_frame(
            opencv_fs.read_cam_pars(fs + "sequSingleFrameData_0.yaml.gz"),
            opencv_fs.read_matches(fs + "matchSingleFrameData_0.yaml.gz"))
        assert frame["pts1"].shape == (300, 2)
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


def test_stereo_refine_defaults_to_the_card():
    """StereoRefine runs on the CUDA card unless asked for the CPU; without
    a card the default raises (no fallback)."""
    from matchinglib_poselib_torch.models.stereo_refine import StereoRefine

    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    if torch.cuda.is_available():
        assert StereoRefine(K, K).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            StereoRefine(K, K)
        with pytest.raises(RuntimeError):
            StereoRefine(K, K, device="cuda")
    assert StereoRefine(K, K, device="cpu").pool.valid.device.type == "cpu"


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
    main path's shapes): FAST+NMS equal to plain away from the border, and
    at every pixel to the plain version of the zero-padded input at
    ragged shapes and every radius 0..5, radius 6 and a negative threshold
    refused; 2-NN bit-exact for every xy_mode, also at ragged shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(np.stack([textured_image(rng, 96, 200)
                                      for _ in range(2)])).cuda()
    out = fast_nms.fast_nms_score(imgs, 12.0 / 255.0, 3)
    ref = fast_nms.fast_nms_score_plain(imgs, 12.0 / 255.0, 3)
    assert torch.equal(out[:, 16:-16, 16:-16], ref[:, 16:-16, 16:-16])
    _, (_, ties) = chip_smoke.check_fast_nms_padded(
        torch, fast_nms, rng, (imgs[:1].contiguous(), imgs), 12.0 / 255.0,
        torch.device("cuda"), scene_min_corners=10)
    assert ties == 0
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score(imgs, 12.0 / 255.0, fast_nms.MAX_RADIUS + 1)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score(imgs, -12.0 / 255.0, 3)
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
    # K2a at chip_smoke.py's ragged shapes
    chip_smoke.check_knn2_ragged(torch, knn2, chip_smoke.knn2_ragged_cases(
        torch, rng, torch.device("cuda")))
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
    # K2b at chip_smoke.py's ragged shapes and depths
    chip_smoke.check_knn2_l2_ragged(
        torch, knn2,
        chip_smoke.knn2_l2_ragged_cases(torch, rng, torch.device("cuda")))


@pytest.mark.gpu
def test_pose_branches_card_vs_cpu():
    """chip_smoke.py phase 4d's card-vs-CPU pose check at a small size:
    each pose branch on the card, then the pose stage again on the CPU
    from the card's correspondences and the same streams; bundle_adjust
    and the eigensolver's Newton loop free of host syncs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import chip_smoke
    from matchinglib_poselib_torch import config as c
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import robust

    img1, img2, K, _, _ = chip_smoke.render_scene(0, 480, 240)
    dev = torch.device("cuda")
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    base = c.PoseConfig(robust=c.RobustConfig(batch_hypotheses=32,
                                              max_batches=4))
    for i, (name, change, _) in enumerate(chip_smoke.pose_menu(c)):
        cfg = dataclasses.replace(base, **change)
        streams = chip_smoke.pose_streams(torch, robust, cfg, i)
        pipe = pipeline.StereoPipeline(
            c.DetectorConfig(max_keypoints=512, fast_threshold=12.0),
            pose_cfg=cfg)
        corr, pose = pipe.run(img1, img2, K, K, np.zeros(5), np.zeros(5),
                              **streams)
        _, fails = chip_smoke.check_pose_card_vs_cpu(
            torch, pipeline, corr, pose, Kt, dist, cfg, streams)
        assert not fails, (name, fails)
        if name == "BA":
            assert not chip_smoke.sync_free_checks(torch, corr, pose, Kt,
                                                   dist)


@pytest.mark.gpu
def test_run_batch_card_vs_cpu():
    """chip_smoke.py phase 7's checks at a small size: run_batch of three
    pairs of the sequence on the card (K1 once, K2a twice per pair), each
    pair equal to run of that pair on the card, and the batch's pose stage
    on the CPU from the card's correspondences."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from matchinglib_poselib_torch import config as c
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import robust

    pairs, K, _, _ = chip_smoke.render_sequence(0, 3, 480, 240)
    cfg = c.PoseConfig(robust=c.RobustConfig(batch_hypotheses=32,
                                             max_batches=4))
    U, D = chip_smoke.batch_streams(torch, robust, cfg, 0, len(pairs))
    pipe = pipeline.StereoPipeline(
        c.DetectorConfig(max_keypoints=512, fast_threshold=12.0),
        pose_cfg=cfg)
    args = (K, K, np.zeros(5), np.zeros(5))
    kernels.reset_launch_counts()
    corr, pose = pipe.run_batch(np.stack([a for a, _ in pairs]),
                                np.stack([b for _, b in pairs]), *args,
                                uniforms=U, degen_uniforms=D)
    counts = kernels.launch_counts()
    assert counts["fast_nms"] == 1 and counts["knn2"] == 2 * len(pairs)
    singles = [pipe.run(a, b, *args, uniforms=U[i], degen_uniforms=D[i])
               for i, (a, b) in enumerate(pairs)]
    _, fails = chip_smoke.batch_vs_run(torch, corr, pose, singles)
    assert not fails, fails
    Kt = torch.from_numpy(K).cuda()
    _, fails = chip_smoke.batch_card_vs_cpu(
        torch, pipeline, corr, pose, Kt, torch.zeros(5, device="cuda"), cfg,
        (U, D))
    assert not fails, fails


@pytest.mark.gpu
def test_stream_card_vs_cpu():
    """chip_smoke.py phase 6's card-vs-CPU check at a small size: four
    frames of the sequence through StereoRefine on the card (a pool of
    2048, 64 x 4 hypotheses), then again on the CPU from the card's
    correspondences with the same streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import chip_smoke
    from matchinglib_poselib_torch import config as c
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.models.stereo_refine import StereoRefine

    pairs, K, _, _ = chip_smoke.render_sequence(0, 4, 696, 256)
    s = chip_smoke.stereo_ref_config(c)
    s = dataclasses.replace(
        s, max_pool_correspondences=2048,
        pose=dataclasses.replace(s.pose, robust=c.RobustConfig(
            batch_hypotheses=64, max_batches=4)))
    pipe = pipeline.StereoPipeline(
        c.DetectorConfig(max_keypoints=1024, fast_threshold=12.0),
        pose_cfg=s.pose)

    def new_sr(device):
        return StereoRefine(K, K, cfg=s, device=device,
                            streams=chip_smoke.SeededStreams(
                                torch, s.pose.robust, 1))

    card = new_sr("cuda")
    corrs, results = [], []
    for i1, i2 in pairs:
        corr = pipe.correspondences(i1, i2)
        corrs.append((corr.pts1, corr.pts2, corr.mask, corr.quality,
                      corr.distance))
        results.append(chip_smoke._feed(card, corrs[-1]))
    cpu = new_sr("cpu")
    for c_card, r in zip(corrs, results):
        r_cpu = chip_smoke._feed(cpu, tuple(x.cpu() for x in c_card))
        assert r.state == r_cpu.state
        assert abs(r.pool_size - r_cpu.pool_size) <= (
            chip_smoke.STREAM_POOL_RTOL * max(r_cpu.pool_size, 1))
        assert chip_smoke._rot_deg(r.R, r_cpu.R) < chip_smoke.POSE_ROT_DEG
        assert chip_smoke._dir_deg(r.t, r_cpu.t) < chip_smoke.POSE_TANG_DEG
