"""Port parity: ``noMatch_poselib-test``, in-process, the port's with
``device="cpu"`` against the JAX package's, on the same frames.

Input: seeded ``frame_*.npz`` ground-truth frames (as tests/test_apps.py
writes them: 3 frames x 300 correspondences, 15% outliers) and the repo's
FileStorage fixture ``eval/fixtures/semireal_fs`` (``--ovf_ext yaml.gz``).
The port is fed the JAX CLI's samples (``fold_in(PRNGKey(0), i)`` per
frame; a ``StereoRefine`` seeded 0) through ``apps.common.frame_streams``
/ ``stereo_refine_streams``. Tolerances: the CSV header equal to the JAX
column list; per row ``R_diffAll`` within 0.1 deg and ``t_angDiff_deg``
within 0.5 deg, ``state`` and the ground-truth columns equal, the same
columns left empty; ``--stereoRef``'s skip counts and stability flags
equal, pool sizes within 1% (ROADMAP §C: the JAX package's post-seeding
dedup decides on rounding noise).
"""

import csv
import pathlib

import numpy as np
import pytest
import torch

from matchinglib_poselib_tpu.apps import nomatch_poselib_test as jn
from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.apps import nomatch_poselib_test as tn

from conftest import random_pose
from test_torch_helpers import (
    jax_cli_frame_streams, jax_stereo_refine_streams,
)

FS_FIXTURE = pathlib.Path(__file__).resolve().parents[1] / "eval" / \
    "fixtures" / "semireal_fs"
ROT_DEG, TANG_DEG = 0.1, 0.5
ACC_ROT_DEG, ACC_TANG_DEG = 1.0, 5.0


@pytest.fixture()
def jax_streams(monkeypatch):
    """The port's CLIs draw the JAX CLIs' samples."""
    monkeypatch.setattr(common, "frame_streams", jax_cli_frame_streams)
    monkeypatch.setattr(common, "stereo_refine_streams",
                        lambda cfg: jax_stereo_refine_streams(0, cfg))


def _write_gt_frames(d, n_frames=3, n=300, noise=0.0008, seed=5):
    """Ground-truth frames as tests/test_apps.py writes them."""
    rng = np.random.default_rng(seed)
    R, t = random_pose(rng, max_angle_deg=8.0)
    K = np.array([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1.0]])
    for i in range(n_frames):
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 12, n)], axis=1)
        x1 = X[:, :2] / X[:, 2:]
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:] + rng.normal(scale=noise, size=(n, 2))
        n_out = n // 7
        x2[:n_out] = rng.uniform(-0.4, 0.4, (n_out, 2))
        inl = np.ones(n, bool)
        inl[:n_out] = False
        np.savez(d / f"frame_{i:04d}.npz",
                 pts1=x1 @ K[:2, :2].T + K[:2, 2],
                 pts2=x2 @ K[:2, :2].T + K[:2, 2],
                 R_GT=R, t_GT=t, K1=K, K2=K, inlier_mask_GT=inl)


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sequ")
    _write_gt_frames(d)
    return d


def _csv(path):
    with open(path) as f:
        reader = csv.reader(f, delimiter=";")
        header = next(reader)
        return header, [dict(zip(header, row)) for row in reader]


def _nomatch_pair(sequ, tmp_path, extra):
    args = ["--sequ_path", str(sequ), *extra, "--output_path"]
    assert jn.main(args + [str(tmp_path / "j")]) == 0
    assert tn.main(args + [str(tmp_path / "t")], device="cpu") == 0
    hj, rows_j = _csv(tmp_path / "j" / "results.csv")
    ht, rows_t = _csv(tmp_path / "t" / "results.csv")
    assert ht == hj == list(tn.CSV_COLUMNS)
    assert len(rows_t) == len(rows_j) > 0
    for rj, rt in zip(rows_j, rows_t):
        assert rt["state"] == rj["state"]
        for col in ("frame", "nrCorrs_GT", "inlRat_GT", "ransac_agg"):
            assert rt[col] == rj[col], col
        assert [c for c in ht if rt[c] == ""] == [c for c in hj
                                                  if rj[c] == ""]
        assert abs(float(rt["R_diffAll"]) - float(rj["R_diffAll"])) < ROT_DEG
        assert abs(float(rt["t_angDiff_deg"])
                   - float(rj["t_angDiff_deg"])) < TANG_DEG
    return rows_j, rows_t


# plain keeps the warm-up frame; the others share its compiled JAX step
@pytest.mark.parametrize("extra", [
    [],
    ["--refineVFC", "--no_warmup"],
    ["--accumCorrs", "2", "--no_warmup"],
], ids=["plain", "vfc", "accum2"])
def test_nomatch_matches_jax_on_npz_frames(gt_dir, tmp_path, jax_streams,
                                           extra):
    rows_j, rows_t = _nomatch_pair(gt_dir, tmp_path, extra)
    for rj, rt in zip(rows_j, rows_t):
        assert float(rt["R_diffAll"]) < ACC_ROT_DEG
        assert float(rt["t_angDiff_deg"]) < ACC_TANG_DEG
        if "--refineVFC" not in extra:
            assert rt["nrCorrs_estimated"] == rj["nrCorrs_estimated"]
    if "--accumCorrs" in extra:
        assert [r["ransac_agg"] for r in rows_t] == ["1", "2", "2"]


def test_nomatch_stereo_ref_matches_jax(gt_dir, tmp_path, jax_streams):
    rows_j, rows_t = _nomatch_pair(
        gt_dir, tmp_path, ["--stereoRef", "--maxPoolCorrespondences",
                           "2048"])
    assert rows_t[0]["state"] in ("init", "robust")
    for rj, rt in zip(rows_j, rows_t):
        for col in ("skipCount", "poseIsStable", "mostLikelyPose_stable"):
            assert rt[col] == rj[col], col
        assert abs(int(rt["poolSize"]) - int(rj["poolSize"])) <= 0.01 * int(
            rj["poolSize"])


def test_nomatch_matches_jax_on_filestorage_fixture(tmp_path, jax_streams):
    rows_j, rows_t = _nomatch_pair(
        FS_FIXTURE, tmp_path, ["--ovf_ext", "yaml.gz", "--no_warmup"])
    assert len(rows_t) == 3
    for rt in rows_t:
        assert float(rt["R_diffAll"]) < ACC_ROT_DEG


def test_cli_refuses_a_missing_card(gt_dir):
    """device="cuda" (the default) without a card raises; no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.main(["--sequ_path", str(gt_dir)])
