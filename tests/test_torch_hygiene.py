"""Port hygiene: no jax at run time, plain versions on the CPU, and (with a
CUDA card) each kernel equal to its plain version."""

import os
import shutil
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
    BA, Kneip, LMEDS, Stewenius), run and run_batch with each of
    chip_smoke's matching options (sub-pixel refinement + VFC, the SOF
    filter) and with LMEDS and the Stewenius solver together, two frames
    of StereoRefine at chip_smoke's stream config (a small pool) with a
    checkpoint round trip, the FileStorage readers, and run at AKAZE/AKAZE
    and FAST/BOLD, and never imports jax."""
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
        for i, (name, change, _) in enumerate(
                chip_smoke.pose_menu(c, base.robust)):
            cfg = dataclasses.replace(base, **change)
            pose = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality, Kt, Kt,
                torch.zeros(5), torch.zeros(5), cfg,
                **chip_smoke.pose_streams(torch, robust, cfg, i))
            assert bool(torch.isfinite(pose.R).all()), name
        both = dataclasses.replace(base, robust=dataclasses.replace(
            base.robust, estimator=c.PoseEstimator.LMEDS,
            solver=c.MinimalSolver.STEWENIUS_5PT))
        fast = c.DetectorConfig(max_keypoints=64, fast_threshold=12.0,
                                column_bands=4)
        for name, m_cfg, _ in chip_smoke.match_menu(c, c.MatchingConfig()):
            pipe = pipeline.StereoPipeline(fast, c.DescriptorConfig(), m_cfg,
                                           both, device="cpu")
            _, mpose = pipe.run(img1, img2, K, K, np.zeros(5), np.zeros(5),
                                torch.Generator().manual_seed(0))
            assert bool(torch.isfinite(mpose.R).all()), name
            _, mpose = pipe.run_batch(np.stack([img1, img3]),
                                      np.stack([img2, img4]), K, K,
                                      np.zeros(5), np.zeros(5),
                                      torch.Generator().manual_seed(0))
            assert bool(torch.isfinite(mpose.R).all()), name
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
        for det_kind, desc_kind in (("AKAZE", "AKAZE"), ("FAST", "BOLD")):
            pipe = pipeline.StereoPipeline(
                c.DetectorConfig(kind=det_kind, max_keypoints=64,
                                 fast_threshold=12.0, column_bands=4),
                c.DescriptorConfig(kind=desc_kind), pose_cfg=base,
                device="cpu")
            fcorr, fpose = pipe.run(img1, img2, K, K, np.zeros(5),
                                    np.zeros(5),
                                    torch.Generator().manual_seed(0))
            assert fcorr.mask.shape == (64,), det_kind
            assert bool(torch.isfinite(fpose.R).all()), det_kind
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


def test_host_layer_and_clis_run_without_importing_jax(tmp_path):
    """A fresh interpreter imports the port's CLIs, ``utils.io``,
    ``utils.visualize``, ``native`` and ``ops.rectify``, runs each CLI on
    the CPU at a tiny size (poselib-test with --showRect, noMatch with
    --stereoRef on the FileStorage fixture) and never imports jax or the
    JAX package."""
    code = textwrap.dedent(f"""
        import contextlib, io, pathlib, sys
        import torch
        torch.set_num_threads(2)
        import chip_smoke
        from matchinglib_poselib_torch import native
        from matchinglib_poselib_torch.apps import (
            common, matchinglib_test, nomatch_poselib_test, poselib_test)
        from matchinglib_poselib_torch.ops import rectify
        from matchinglib_poselib_torch.utils import io as tio, visualize
        d = pathlib.Path({str(tmp_path)!r})
        pairs, K, R, t = chip_smoke.render_sequence(0, 2, 192, 96)
        chip_smoke.write_stereo_dir(d / "imgs", pairs, K, R, t)
        img = ["--img_path", str(d / "imgs"), "--f_nr", "64"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert matchinglib_test.main(
                img + ["--output_path", str(d / "m")], device="cpu") == 0
            assert poselib_test.main(
                img + ["--showRect", "--compInitPose", "--output_path",
                       str(d / "p")], device="cpu") == 0
            assert nomatch_poselib_test.main(
                ["--sequ_path", "eval/fixtures/semireal_fs", "--ovf_ext",
                 "yaml.gz", "--no_warmup", "--stereoRef",
                 "--maxPoolCorrespondences", "512", "--output_path",
                 str(d / "n")], device="cpu") == 0
        assert (d / "m" / "matches_0001.npz").exists()
        assert (d / "p" / "rect_pair_0001.png").exists()
        assert (d / "n" / "results.csv").exists()
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


def test_library_layer_runs_without_importing_jax(tmp_path):
    """A fresh interpreter imports ``ops.optflow``, ``apps.ros_interface``,
    ``entry``, the example and ``parallel.*``, runs each on the CPU at a
    tiny size (LK flow with LKOF and ALKOF, the node over a frame plain
    and with stereoRef, ``entry(device="cpu")``'s step, the example on a
    written stereo directory, a ``trace``, ``dryrun_multichip`` in a gloo
    world of 1) and never imports jax or the JAX package."""
    code = textwrap.dedent(f"""
        import contextlib, io, pathlib, sys
        import numpy as np, torch
        torch.set_num_threads(2)
        import chip_smoke
        from matchinglib_poselib_torch import entry
        from matchinglib_poselib_torch.apps import ros_interface
        from matchinglib_poselib_torch.examples import match_and_pose
        from matchinglib_poselib_torch.ops import optflow
        from matchinglib_poselib_torch.parallel import ba, matching, mesh
        from matchinglib_poselib_torch.parallel import stream
        from matchinglib_poselib_torch.utils import profiling
        d = pathlib.Path({str(tmp_path)!r})
        pairs, K, R, t = chip_smoke.render_sequence(0, 2, 320, 240)
        chip_smoke.write_stereo_dir(d / "imgs", pairs, K, R, t)
        (a, b), (c, _) = pairs
        kp = torch.tensor([[60.0, 40.0], [100.0, 50.0]])
        ok = torch.ones(2, dtype=torch.bool)
        words = torch.zeros(2, 8, dtype=torch.int32)
        with profiling.trace(str(d / "trace")):
            fl = optflow.lk_flow(torch.tensor(a), torch.tensor(c), kp, ok)
        assert list((d / "trace").iterdir())
        assert fl.pts.shape == (2, 2)
        optflow.match_lkof(kp, kp, ok, ok, torch.tensor(a), torch.tensor(c))
        optflow.match_alkof(kp, kp, words, words, ok, ok, torch.tensor(a),
                            torch.tensor(c))
        for params in ({{"nrFeatures": 64}},
                       {{"nrFeatures": 64, "stereoRef": "1"}}):
            node = ros_interface.MatchingPoselibNode(params, device="cpu")
            node.set_calibration(K, K, np.zeros(5), np.zeros(5))
            msg = node.handle_stereo_pair(a, b)
            assert msg.R.shape == (3, 3)
        fn, args = entry.entry(device="cpu")
        assert fn(*args)[0].shape == (3, 3)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert match_and_pose.main([str(d / "imgs")], device="cpu") == 0
        assert "matches" in out.getvalue() and "inliers" in out.getvalue()
        import torch.distributed as dist
        dist.init_process_group("gloo", store=dist.FileStore(
            str(d / "store"), 1), rank=0, world_size=1)
        res = entry.dryrun_multichip(device="cpu")
        assert res.mesh_shape == (1, 1) and res.knn_matched == 64
        assert res.R.shape == (2, 3, 3)
        dist.destroy_process_group()
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


@pytest.mark.parametrize("module", [
    "ops/optflow.py", "apps/ros_interface.py", "entry.py",
    "examples/match_and_pose.py", "utils/profiling.py", "apps/common.py",
    "parallel/mesh.py", "parallel/matching.py", "parallel/ba.py",
    "parallel/stream.py",
])
def test_library_layer_picks_no_device_on_its_own(module):
    """The library layer's entry points run on the device they are given:
    none of these modules asks whether there is a card, but
    ``apps.common.cli_device``, which raises without one (no fallback to
    the CPU)."""
    with open(os.path.join(REPO, "matchinglib_poselib_torch", module)) as f:
        src = f.read()
    n_checks = src.count("torch.cuda.is_available()")
    if module == "apps/common.py":
        assert n_checks == 1
        from matchinglib_poselib_torch.apps import common

        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                common.cli_device("cuda", "entry")
        assert common.cli_device("cpu").type == "cpu"
    else:
        assert n_checks == 0


def test_native_loader_builds_only_into_build_dir(tmp_path):
    """Building the port's image loader writes nothing outside
    ``matchinglib_poselib_torch/_build/`` (a copy of the package, built in
    a fresh interpreter)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    src = os.path.join(REPO, "matchinglib_poselib_torch")
    shutil.copytree(src, tmp_path / "matchinglib_poselib_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p for p in tmp_path.rglob("*")}
    code = textwrap.dedent("""
        from matchinglib_poselib_torch import native
        assert native.available(), native.BUILD_ERROR
        assert native.load_image_gray("/nonexistent.png") is None
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(tmp_path),
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    new = {p for p in tmp_path.rglob("*")} - before
    build = tmp_path / "matchinglib_poselib_torch" / "_build"
    assert new and all(p == build or build in p.parents for p in new), new
    assert [p.name for p in build.iterdir() if p.suffix == ".so"] == [
        p.name for p in new if p.suffix == ".so"]


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
    ragged shapes and every radius 0..5, and at a negative threshold;
    radius 6 refused; 2-NN bit-exact for every xy_mode, also at ragged
    shapes."""
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
    # a negative threshold: its own instantiation, bit-exact at every
    # pixel against the zero-padded plain version
    for radius in (0, 3):
        _, n_ties = chip_smoke.check_fast_nms(
            torch, fast_nms, imgs, -12.0 / 255.0, radius, min_corners=10)
        assert n_ties == 0
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
    for i, (name, change, _) in enumerate(chip_smoke.pose_menu(c,
                                                               base.robust)):
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
def test_match_menu_card_vs_cpu():
    """chip_smoke.py phase 4e's checks at a small size: each matching
    option on the card (K1 twice, K2a twice or once), the CPU path's slots
    against the card's, and each filter on the card against the CPU from
    the same correspondences."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from matchinglib_poselib_torch import config as c
    from matchinglib_poselib_torch.models import pipeline

    img1, img2, K, _, _ = chip_smoke.render_scene(0, 480, 240)
    det = c.DetectorConfig(max_keypoints=512, fast_threshold=12.0)
    i1, i2 = (torch.from_numpy(x).cuda() for x in (img1, img2))
    for name, m_cfg, expected in chip_smoke.match_menu(c, c.MatchingConfig()):
        kernels.reset_launch_counts()
        corr = pipeline.get_correspondences(i1, i2, det, c.DescriptorConfig(),
                                            m_cfg)
        counts = kernels.launch_counts()
        assert all(counts[k] == v for k, v in expected.items()), (name,
                                                                  counts)
        agree = chip_smoke.cpu_agreement(torch, pipeline, corr, img1, img2,
                                         det, c.DescriptorConfig(), m_cfg)
        assert min(agree.values()) >= 0.99, (name, agree)
        _, fails = chip_smoke.filters_card_vs_cpu(
            torch, pipeline, i1, i2, det, c.DescriptorConfig(), m_cfg)
        assert not fails, (name, fails)


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


@pytest.mark.gpu
def test_frontend_rows_card_vs_cpu():
    """chip_smoke.py phase 9's checks at a small size: K2a at 2, 4 and 16
    words (ragged shapes, the 512-bit key's extreme pairs, 17 words
    refused) and K2b at the float rows' depths against their plain
    versions; then every row of frontend_rows on the card with its
    launches (frontend_expected), and the CPU path's slots, aligned by
    position, against the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from matchinglib_poselib_torch import config as c
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import features

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for width in chip_smoke.FRONTEND_WIDTHS:
        chip_smoke.check_knn2_ragged(
            torch, knn2, chip_smoke.knn2_ragged_cases(torch, rng, dev, width))
    chip_smoke.check_knn2_extreme(torch, knn2,
                                  chip_smoke.knn2_extreme_cases(torch, dev))
    with pytest.raises(ValueError):
        wide = torch.zeros((4, 17), dtype=torch.int32, device=dev)
        knn2.knn2(wide, wide, torch.ones(4, dtype=torch.bool, device=dev))
    chip_smoke.check_knn2_l2_ragged(
        torch, knn2, chip_smoke.knn2_l2_ragged_cases(
            torch, rng, dev, depths=chip_smoke.FRONTEND_L2_DEPTHS))
    img1, img2, _, _, _ = chip_smoke.render_scene(0, 480, 240)
    i1, i2 = (torch.from_numpy(x).to(dev) for x in (img1, img2))
    match = c.MatchingConfig()
    for name, det, desc in chip_smoke.frontend_rows(c):
        kernels.reset_launch_counts()
        corr = pipeline.get_correspondences(i1, i2, det, desc, match)
        counts = kernels.launch_counts()
        want = chip_smoke.frontend_expected(features, det, desc)
        assert counts == want, (name, counts, want)
        cpu = pipeline.get_correspondences(torch.from_numpy(img1),
                                           torch.from_numpy(img2), det,
                                           desc, match)
        agree = chip_smoke.aligned_agreement(corr, cpu)
        assert min(agree.values()) >= chip_smoke.FRONTEND_AGREE, (name, agree)
