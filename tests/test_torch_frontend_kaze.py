"""AKAZE/AKAZE through ``get_correspondences`` and ``matchinglib-test``:
port vs JAX package, on the CPU.

Input: two frames of ``chip_smoke.render_sequence`` at 240x480 written as
8-bit grey PNGs with a KITTI ``calib_cam_to_cam.txt``, 512 keypoints;
the CLIs in-process (the port's with ``device="cpu"``). The JAX CLI and
the ``get_correspondences`` parity share one compiled program (the same
configs and shape): the KAZE scale space is 186 explicit diffusion steps
per image, which XLA takes about two minutes to compile.

Tolerances: KAZE keypoints flip on f32 near ties of the Hessian
determinant across levels (tests/test_torch_detectors_ext.py, ROADMAP C),
and a flipped keypoint moves every later slot, so both are compared by
position:
- ``get_correspondences``: keypoints aligned by position on >= 98% of
  those valid on either side (measured 98.5% and 99.4% for the two
  images of frame 1), and on the aligned query slots the match mask and
  the partner position (within 1e-4 px) on >= 99% (measured 99.4%).
- ``matchinglib-test``: each pair's stored matches (pts1, pts2, distance)
  found row for row in the JAX CLI's on >= 95% of the union (measured
  95.8% and 100%), the printed match counts within 2% (measured equal:
  94 and 91); the MLDB distances agree exactly wherever both keep the
  same match.
"""

import contextlib
import io as sio
import json

import numpy as np
import pytest

import jax.numpy as jnp

from matchinglib_poselib_tpu.apps import common as jcommon
from matchinglib_poselib_tpu.apps import matchinglib_test as jm
from matchinglib_poselib_tpu.models import pipeline as jpipe
from matchinglib_poselib_tpu.utils import io as jio
from matchinglib_poselib_torch.apps import common as tcommon
from matchinglib_poselib_torch.apps import matchinglib_test as tm
from matchinglib_poselib_torch.models import pipeline as tpipe

import chip_smoke
from test_torch_frontend_menu import compare_aligned
from test_torch_helpers import t

ARGS = ["--f_detect", "AKAZE", "--d_extr", "AKAZE", "--f_nr", "512"]


@pytest.fixture(scope="module")
def stereo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    pairs, K, R, tt = chip_smoke.render_sequence(0, frames=2, width=480,
                                                 height=240)
    chip_smoke.write_stereo_dir(d, pairs, K, R, tt)
    return d


def _run(main, argv, **kw):
    buf = sio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def cli_runs(stereo_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    args = ["--img_path", str(stereo_dir), *ARGS, "--output_path"]
    rc_j, lines_j = _run(jm.main, args + [str(out / "j")])
    rc_t, lines_t = _run(tm.main, args + [str(out / "t")], device="cpu")
    assert rc_j == rc_t == 0
    return out, lines_j, lines_t


def test_get_correspondences_akaze_matches_jax(stereo_dir, cli_runs):
    """Frame 1 as the CLIs decode it, with the CLIs' own configs."""
    pairs = jio.load_stereo_sequence(stereo_dir, "left_", "right_")
    img1, img2 = (jio.load_image_gray(p) for p in pairs[0])
    parser = jm.build_parser()
    jargs = parser.parse_args(["--img_path", str(stereo_dir), *ARGS])
    targs = tm.build_parser().parse_args(["--img_path", str(stereo_dir),
                                          *ARGS])
    jr = jpipe.get_correspondences(jnp.asarray(img1), jnp.asarray(img2),
                                   *jcommon.matching_configs(jargs))
    tr = tpipe.get_correspondences(t(img1), t(img2),
                                   *tcommon.matching_configs(targs))
    compare_aligned(jr, tr, kp_share=0.98, match_share=0.99, min_matches=50)


def _rows(path):
    z = np.load(path)
    return {tuple(np.round(np.concatenate([z["pts1"][i], z["pts2"][i]]), 4))
            : float(z["distance"][i]) for i in range(len(z["distance"]))}


def test_matchinglib_test_akaze_matches_jax(cli_runs):
    out, lines_j, lines_t = cli_runs
    sj, st = json.loads(lines_j[-1]), json.loads(lines_t[-1])
    assert st["pairs"] == sj["pairs"] == 2
    for lj, lt in zip(lines_j[:-1], lines_t[:-1]):
        nj, nt = int(lj.split()[-2]), int(lt.split()[-2])
        assert abs(nj - nt) <= 0.02 * nj, (lj, lt)
        assert nj > 50
    for i in range(2):
        rj = _rows(out / "j" / f"matches_{i:04d}.npz")
        rt = _rows(out / "t" / f"matches_{i:04d}.npz")
        both = set(rj) & set(rt)
        assert len(both) >= 0.95 * len(set(rj) | set(rt)), i
        assert all(rj[k] == rt[k] for k in both)
