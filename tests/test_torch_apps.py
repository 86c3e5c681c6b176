"""Port parity: the three CLIs, in-process, the port's with
``device="cpu"`` against the JAX package's, on the same files.

Input: two frames of ``chip_smoke.render_sequence`` at 240x480 written as
8-bit grey PNGs with a KITTI ``calib_cam_to_cam.txt``
(``chip_smoke.write_stereo_dir``), 512 keypoints. The noMatch CLI's
parity is in tests/test_torch_apps_nomatch.py.

Where the JAX CLI samples (``fold_in(PRNGKey(0), i)`` per frame, a
``StereoRefine`` seeded 0), the port is fed the same samples through
``apps.common.frame_streams`` / ``stereo_refine_streams``, the functions a
caller replaces for that. Tolerances: match slots, printed counts, stored
matches and drawings equal; poses within 0.1 deg (rotation) and 0.5 deg
(translation direction); ``--stereoRef`` states equal; the rectified PNGs
equal up to one level where the float images lie within 2e-5 of a level's
edge (``RECT_ATOL``).
"""

import contextlib
import io as sio
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from matchinglib_poselib_tpu.apps import matchinglib_test as jm
from matchinglib_poselib_tpu.apps import poselib_test as jp
from matchinglib_poselib_tpu.models import pipeline as jpipe
from matchinglib_poselib_tpu.ops import rectify as jrect
from matchinglib_poselib_tpu.utils import io as jio
from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.apps import matchinglib_test as tm
from matchinglib_poselib_torch.apps import poselib_test as tp
from matchinglib_poselib_torch.models import pipeline as tpipe

import chip_smoke
from test_torch_helpers import (
    dir_angle_deg, jax_cli_frame_streams, jax_stereo_refine_streams,
    rot_chordal_deg,
)

ROT_DEG, TANG_DEG = 0.1, 0.5
# accuracy bars against the planted pose (tests/test_pipeline.py:88-89)
ACC_ROT_DEG, ACC_TANG_DEG = 1.0, 5.0
# the rectified images' float values: the rectification is the JAX
# package's to the bit, but XLA's CPU dot sums each pixel's ray in an order
# of its own, so the sample coordinates differ by a few f32 ulps (3e-5 px
# at 256-480 px) and the images by up to 1.3e-5 at this size
# (tests/test_torch_rectify.py holds 1e-5 at 120x160)
RECT_ATOL = 2e-5
IMG = ["--f_nr", "512"]


@pytest.fixture(scope="module")
def stereo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    pairs, K, R, t = chip_smoke.render_sequence(0, frames=2, width=480,
                                                 height=240)
    chip_smoke.write_stereo_dir(d, pairs, K, R, t)
    return d


def _run(main, argv, **kw):
    """main(argv) with its stdout captured -> (rc, stdout lines)."""
    buf = sio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().strip().splitlines()


@pytest.fixture()
def jax_streams(monkeypatch):
    """The port's CLIs draw the JAX CLIs' samples."""
    monkeypatch.setattr(common, "frame_streams", jax_cli_frame_streams)
    monkeypatch.setattr(common, "stereo_refine_streams",
                        lambda cfg: jax_stereo_refine_streams(0, cfg))


@pytest.fixture()
def recorded_poses(monkeypatch):
    """Every single-pair estimate_pose result of either package, in call
    order (the port's runs one pair as a batch of one, a nested call)."""
    out = {"jax": [], "torch": []}
    for name, mod in (("jax", jpipe), ("torch", tpipe)):
        def wrapped(*a, _f=mod.estimate_pose, _name=name, **kw):
            res = _f(*a, **kw)
            if res.R.ndim == 2:
                out[_name].append((np.asarray(res.R), np.asarray(res.t)))
            return res
        monkeypatch.setattr(mod, "estimate_pose", wrapped)
    return out


def test_matchinglib_test_matches_jax(stereo_dir, tmp_path):
    args = ["--img_path", str(stereo_dir), *IMG, "--output_path"]
    rc_j, out_j = _run(jm.main, args + [str(tmp_path / "j")])
    rc_t, out_t = _run(tm.main, args + [str(tmp_path / "t")], device="cpu")
    assert rc_j == rc_t == 0
    # the per-pair match counts, then the summary's pairs and total
    assert out_t[:-1] == out_j[:-1]
    sj, st = json.loads(out_j[-1]), json.loads(out_t[-1])
    assert (st["pairs"], st["total_matches"]) == (sj["pairs"],
                                                  sj["total_matches"])
    assert set(st["stage_ms"]) == set(sj["stage_ms"])
    assert st["total_matches"] > 100
    for i in range(2):
        a = np.load(tmp_path / "j" / f"matches_{i:04d}.npz")
        b = np.load(tmp_path / "t" / f"matches_{i:04d}.npz")
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        png = f"matches_{i:04d}.png"
        assert (tmp_path / "t" / png).read_bytes() == \
            (tmp_path / "j" / png).read_bytes()


def _rect_equal_up_to_edges(got_u8, want_float):
    """A CLI's uint8 PNG against the float image it quantizes: equal, or
    one level off where the float lies within RECT_ATOL of a level's edge
    (the CLI writes floor(255 clip(v)))."""
    scaled = np.clip(want_float, 0, 1) * 255.0
    want_u8 = scaled.astype(np.uint8)
    diff = np.abs(got_u8.astype(int) - want_u8.astype(int))
    near = np.abs(scaled - np.round(scaled)) <= 255.0 * RECT_ATOL
    assert diff.max() <= 1
    assert np.all(near[diff > 0])


def test_poselib_test_matches_jax_with_its_samples(
        stereo_dir, tmp_path, jax_streams, recorded_poses):
    args = ["--img_path", str(stereo_dir), *IMG, "--compInitPose",
            "--showRect", "--output_path"]
    rc_j, out_j = _run(jp.main, args + [str(tmp_path / "j")])
    rc_t, out_t = _run(tp.main, args + [str(tmp_path / "t")], device="cpu")
    assert rc_j == rc_t == 0
    assert len(out_t) == len(out_j) == 3
    for lj, lt, (Rj, tj), (Rt, tt) in zip(out_j[:2], out_t[:2],
                                           recorded_poses["jax"],
                                           recorded_poses["torch"]):
        rj, rt = json.loads(lj), json.loads(lt)
        assert set(rt) == set(rj)
        for k in ("frame", "n_matches", "n_inliers", "degenerate"):
            assert rt[k] == rj[k], k
        assert rot_chordal_deg(Rj, Rt) < ROT_DEG
        assert dir_angle_deg(tj, tt) < TANG_DEG
        assert rt["R_diff_deg"] < ACC_ROT_DEG
        assert rt["t_angDiff_deg"] < ACC_TANG_DEG
    summary = json.loads(out_t[-1])
    assert summary["frames"] == 2
    assert set(summary["stage_ms"]) == {"correspondences", "pose"}
    # the rectified images: the port's PNGs against the JAX package's
    # rectification of the port's pose on the same decoded images
    calib = jio.load_kitti_calib(stereo_dir / "calib_cam_to_cam.txt")
    K1, K2 = (jnp.asarray(k, jnp.float32) for k in (calib.K0, calib.K1))
    d = jnp.zeros(5, jnp.float32)
    for i, (R, t) in enumerate(recorded_poses["torch"]):
        im1 = jio.load_image_gray(stereo_dir / f"left_{i:04d}.png")
        im2 = jio.load_image_gray(stereo_dir / f"right_{i:04d}.png")
        rect = jrect.get_rectification_parameters(
            K1, K2, jnp.asarray(R), jnp.asarray(t), d, d, im1.shape)
        r1 = np.asarray(jrect.rectified_image(
            jnp.asarray(im1), K1, d, rect.R1, rect.K_new1, im1.shape))
        r2 = np.asarray(jrect.rectified_image(
            jnp.asarray(im2), K2, d, rect.R2, rect.K_new2, im2.shape))
        for name, want in (("rect_left", r1), ("rect_right", r2)):
            got = np.asarray(Image.open(tmp_path / "t" / f"{name}_{i:04d}.png"))
            assert got.shape == im1.shape
            _rect_equal_up_to_edges(got, want)
        pair = np.asarray(Image.open(tmp_path / "t" / f"rect_pair_{i:04d}.png"))
        assert pair.shape == (240, 960, 3)
        assert (tmp_path / "j" / f"rect_pair_{i:04d}.png").exists()


def test_poselib_test_free_running(stereo_dir):
    """The port's own samples (one generator seeded 0), with the reference
    options a user sets: the accuracy bars and the JAX CLI's fields."""
    rc, out = _run(tp.main, ["--img_path", str(stereo_dir), *IMG,
                             "--compInitPose", "--histEqual", "--v", "1"],
                   device="cpu")
    assert rc == 0
    recs = [json.loads(line) for line in out if line.startswith("{")]
    frames = [r for r in recs if "frame" in r]
    assert len(frames) == 2
    for r in frames:
        assert set(r) == {"frame", "n_matches", "n_inliers", "inlier_ratio",
                          "degenerate", "usac", "R_diff_deg",
                          "t_angDiff_deg"}
        assert r["R_diff_deg"] < ACC_ROT_DEG
        assert r["t_angDiff_deg"] < ACC_TANG_DEG
        assert r["usac"]["models_generated"] > 0


def test_hist_equal_matches_jax():
    rng = np.random.default_rng(0)
    # 8-bit values: ties are the rule
    img = np.round(rng.random((48, 64)) * 40) / 255.0
    img = img.astype(np.float32)
    flat = jnp.asarray(img).ravel()
    want = np.asarray(
        jnp.argsort(jnp.argsort(flat)).astype(jnp.float32) / flat.size
    ).reshape(img.shape)
    got = tp.hist_equal(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, want)


def test_poselib_test_stereo_ref_matches_jax(stereo_dir, jax_streams):
    args = ["--img_path", str(stereo_dir), *IMG, "--stereoRef",
            "--compInitPose", "--maxPoolCorrespondences", "4096"]
    rc_j, out_j = _run(jp.main, args)
    rc_t, out_t = _run(tp.main, args, device="cpu")
    assert rc_j == rc_t == 0
    for lj, lt in zip(out_j[:2], out_t[:2]):
        rj, rt = json.loads(lj), json.loads(lt)
        assert set(rt) == set(rj)
        assert (rt["state"], rt["stable"]) == (rj["state"], rj["stable"])
        assert abs(rt["pool_size"] - rj["pool_size"]) <= 0.01 * rj[
            "pool_size"]
        assert abs(rt["R_diff_deg"] - rj["R_diff_deg"]) < ROT_DEG
        assert abs(rt["t_angDiff_deg"] - rj["t_angDiff_deg"]) < TANG_DEG
    assert json.loads(out_t[0])["state"] == "init"
    assert set(json.loads(out_t[-1])["stage_ms"]) == {"correspondences",
                                                      "stereoRefine"}


@pytest.mark.parametrize("cli", ["matchinglib_test", "poselib_test"])
def test_cli_refuses_a_missing_card(stereo_dir, cli):
    """device="cuda" (the default) without a card raises; no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    main = {"matchinglib_test": tm.main, "poselib_test": tp.main}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--img_path", str(stereo_dir)])
