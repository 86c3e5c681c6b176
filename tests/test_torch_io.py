"""Port parity: the host layer (``utils/io.py``, ``native/``,
``utils/visualize.py`` and the FileStorage writers of
``utils/opencv_fs.py``) against the JAX package.

Everything here is exact: decoded pixels bit-equal, PNG and FileStorage
bytes equal (a gzip file's 4-byte mtime field aside), drawings equal.
"""

import gzip
import pathlib

import numpy as np
import pytest
from PIL import Image

from matchinglib_poselib_tpu import native as jnative
from matchinglib_poselib_tpu.utils import io as jio
from matchinglib_poselib_tpu.utils import opencv_fs as jfs
from matchinglib_poselib_tpu.utils import visualize as jvis
from matchinglib_poselib_torch import native as tnative
from matchinglib_poselib_torch.utils import io as tio
from matchinglib_poselib_torch.utils import opencv_fs as tfs
from matchinglib_poselib_torch.utils import visualize as tvis

import chip_smoke

SHAPE = (37, 53)


def _write_image(path, kind, rng):
    """One file of each encoding tests/test_native_loader.py decodes."""
    h, w = SHAPE
    u8 = (rng.random((h, w)) * 255).astype(np.uint8)
    rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    if kind == "png_gray8":
        Image.fromarray(u8, "L").save(path)
    elif kind == "png_gray16":
        # a uint16 array is Pillow's 16-bit grey mode, "I;16"
        Image.fromarray((rng.random((h, w)) * 65535).astype(np.uint16)
                        ).save(path)
    elif kind == "png_rgb":
        Image.fromarray(rgb, "RGB").save(path)
    elif kind == "png_rgba":
        rgba = np.concatenate([rgb, u8[..., None]], axis=2)
        Image.fromarray(rgba, "RGBA").save(path)
    elif kind == "png_palette":
        Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE,
                                            colors=64).save(path)
    elif kind == "pgm_binary":
        path.write_bytes(b"P5\n# c\n%d %d\n255\n" % (w, h) + u8.tobytes())
    elif kind == "ppm_binary":
        path.write_bytes(b"P6 %d %d 255\n" % (w, h) + rgb.tobytes())
    elif kind == "pgm_ascii":
        body = " ".join(str(int(v)) for v in u8.ravel())
        path.write_text(f"P2\n{w} {h}\n255\n{body}\n")
    elif kind == "ppm_ascii":
        body = " ".join(str(int(v)) for v in rgb.ravel())
        path.write_text(f"P3\n{w} {h}\n255\n{body}\n")
    else:
        raise ValueError(kind)


KINDS = ("png_gray8", "png_gray16", "png_rgb", "png_rgba", "png_palette",
         "pgm_binary", "ppm_binary", "pgm_ascii", "ppm_ascii")


@pytest.fixture(scope="module")
def loaders():
    if not (tnative.available() and jnative.available()):
        pytest.skip("native loader toolchain unavailable")


@pytest.mark.parametrize("kind", KINDS)
def test_loader_bit_equal(tmp_path, loaders, kind):
    rng = np.random.default_rng(KINDS.index(kind))
    path = tmp_path / f"img.{kind.split('_')[0]}"
    _write_image(path, kind, rng)
    want = jnative.load_image_gray(path)
    got = tnative.load_image_gray(path)
    assert want is not None and got is not None
    assert got.dtype == np.float32 and got.shape == SHAPE
    assert np.array_equal(got, want)
    assert np.array_equal(tio.load_image_gray(path), jio.load_image_gray(path))


def test_load_images_batch_threads(tmp_path, loaders):
    rng = np.random.default_rng(5)
    paths = []
    for i, kind in enumerate(("png_gray8", "png_rgb", "pgm_binary",
                              "png_gray16")):
        paths.append(tmp_path / f"f{i}.{kind.split('_')[0]}")
        _write_image(paths[-1], kind, rng)
    want = jio.load_images_batch(paths, n_threads=3)
    got = tio.load_images_batch(paths, n_threads=3)
    assert got.shape == (4,) + SHAPE
    assert np.array_equal(got, want)
    out, good = tnative.load_batch_gray(paths, *SHAPE, n_threads=3)
    assert good == 4 and np.array_equal(out, want)
    # a file of another size: the batch falls back per file, as JAX's does
    odd = tmp_path / "odd.png"
    Image.fromarray(np.zeros((5, 7), np.uint8), "L").save(odd)
    _, good = tnative.load_batch_gray(paths + [odd], *SHAPE, n_threads=2)
    assert good == 4


def test_missing_file(loaders):
    assert tnative.load_image_gray("/nonexistent/file.png") is None
    assert jnative.load_image_gray("/nonexistent/file.png") is None


def test_native_builds_into_build_dir(loaders):
    so = tnative.library_path()
    assert so.exists()
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "matchinglib_poselib_torch"


def test_kitti_calib_and_stereo_sequence(tmp_path):
    pairs, K, R, t, = chip_smoke.render_sequence(0, frames=2, width=64,
                                                  height=32)
    chip_smoke.write_stereo_dir(tmp_path, pairs, K, R, t)
    # a real KITTI file's header rows carry text and are skipped
    calib = tmp_path / "calib_cam_to_cam.txt"
    calib.write_text("calib_time: 09-Jan-2012 13:57:47\ncorner_dist: "
                     "9.950000e-02\n" + calib.read_text())
    want = jio.load_kitti_calib(calib)
    got = tio.load_kitti_calib(calib)
    for f in ("K0", "K1", "dist0", "dist1", "R", "t"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_allclose(got.R, R, atol=1e-12)
    np.testing.assert_allclose(got.t, t, atol=1e-12)
    (tmp_path / "other.txt").write_text("x")
    assert tio.load_stereo_sequence(tmp_path) == jio.load_stereo_sequence(
        tmp_path)
    assert len(tio.load_stereo_sequence(tmp_path)) == 2
    assert tio.load_image_sequence(tmp_path, "left_") == \
        jio.load_image_sequence(tmp_path, "left_")


@pytest.mark.parametrize("case", ["gray_u8", "gray_float", "rgb"])
def test_write_png_bytes_equal(tmp_path, case):
    rng = np.random.default_rng(1)
    img = {"gray_u8": (rng.random(SHAPE) * 255).astype(np.uint8),
           "gray_float": rng.random(SHAPE) * 300 - 20,
           "rgb": (rng.random(SHAPE + (3,)) * 255).astype(np.uint8)}[case]
    tvis.write_png(tmp_path / "t.png", img)
    jvis.write_png(tmp_path / "j.png", img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png"
                                                 ).read_bytes()
    decoded = np.asarray(Image.open(tmp_path / "t.png"))
    assert decoded.shape == img.shape


@pytest.mark.parametrize("max_draw", [50, 0, 7])
def test_drawings_equal(max_draw):
    rng = np.random.default_rng(2)
    img1 = rng.random((40, 60)).astype(np.float32)
    img2 = (rng.random((36, 50)) * 255).astype(np.uint8)
    p1 = rng.uniform(-5, 65, (80, 2))
    p2 = rng.uniform(-5, 55, (80, 2))
    mask = rng.random(80) > 0.3
    want = jvis.draw_matches(img1, p1, img2, p2, mask=mask,
                             max_draw=max_draw)
    got = tvis.draw_matches(img1, p1, img2, p2, mask=mask, max_draw=max_draw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(
        tvis.draw_rectified_pair(img1, img2, line_step=8),
        jvis.draw_rectified_pair(img1, img2, line_step=8))


def _fs_inputs(rng):
    n = 12
    kp = np.concatenate([rng.uniform(0, 500, (n, 2)), np.full((n, 1), 31.0),
                         rng.uniform(0, 360, (n, 1)), rng.random((n, 1)),
                         np.zeros((n, 1)), np.full((n, 1), -1.0)], axis=1)
    mt = np.stack([np.arange(n), rng.permutation(n), np.zeros(n),
                   rng.uniform(0, 60, n)], axis=1)
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    inl = rng.random(n) > 0.2
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    K = np.array([[700.0, 0, 320.5], [0, 702.25, 240.0], [0, 0, 1.0]])
    return kp, mt, desc, inl, R, K


@pytest.mark.parametrize("ext", ["yaml", "xml", "yaml.gz"])
def test_filestorage_writers_bytes_equal(tmp_path, ext):
    rng = np.random.default_rng(4)
    kp, mt, desc, inl, R, K = _fs_inputs(rng)
    Hs = [rng.normal(size=(3, 3)) for _ in range(2)]

    def write(mod, tag):
        cam = tmp_path / f"sequSingleFrameData_{tag}.{ext}"
        mat = tmp_path / f"matchSingleFrameData_{tag}.{ext}"
        mod.write_cam_pars(cam, 3, R, [0.5, -0.1, 0.02], K, K, K * 1.01,
                           K * 0.99)
        mod.write_matches(mat, kp, kp[::-1], desc, desc[::-1], mt, inl,
                          homographies=Hs, src_idx1=[1, 2],
                          corr_type=[0, 1, 2])
        mod.write_filestorage(tmp_path / f"misc_{tag}.{ext}", {
            "a_int": 7, "a_float": 2.5, "a_whole": 3.0, "name": "x",
            "vec": [1, 2, 3], "mat_f": np.eye(2, dtype=np.float32)})
        return cam, mat

    tcam, tmat = write(tfs, "t")
    jcam, jmat = write(jfs, "j")
    for a, b in ((tcam, jcam), (tmat, jmat),
                 (tmp_path / f"misc_t.{ext}", tmp_path / f"misc_j.{ext}")):
        ta, jb = a.read_bytes(), b.read_bytes()
        if ext.endswith(".gz"):
            # the header's mtime (bytes 4-7) is the clock's
            assert ta[:4] + ta[8:] == jb[:4] + jb[8:]
            ta, jb = gzip.decompress(ta), gzip.decompress(jb)
        assert ta == jb
    # the port writes, both packages read back the same values
    for rd in (tfs, jfs):
        cp = rd.read_cam_pars(tcam)
        np.testing.assert_allclose(cp["actR"], R, rtol=1e-15)
        assert cp["actFrameCnt"] == 3
        sm = rd.read_matches(tmat)
        np.testing.assert_allclose(sm["frameKeypoints1"], kp, rtol=1e-6)
        assert np.array_equal(sm["frameDescriptors1"], desc)
        assert np.array_equal(np.asarray(sm["frameInliers"]).astype(bool),
                              inl)
    t_frame = tfs.sequ_frame(tfs.read_cam_pars(tcam), tfs.read_matches(tmat))
    j_frame = jfs.sequ_frame(jfs.read_cam_pars(tcam), jfs.read_matches(tmat))
    assert set(t_frame) == set(j_frame)
    for k in t_frame:
        assert np.array_equal(np.asarray(t_frame[k]),
                              np.asarray(j_frame[k])), k


def test_committed_fixture_round_trips(tmp_path):
    """The repo's FileStorage fixture, read and written again by the port,
    gives the JAX writer's bytes."""
    fix = pathlib.Path(__file__).resolve().parents[1] / "eval" / "fixtures" \
        / "semireal_fs"
    cp = tfs.read_cam_pars(fix / "sequSingleFrameData_0.yaml.gz")
    args = (cp["actFrameCnt"], cp["actR"], cp["actT"], cp["K1"], cp["K2"],
            cp["actKd1"], cp["actKd2"])
    tfs.write_cam_pars(tmp_path / "t.yaml", *args)
    jfs.write_cam_pars(tmp_path / "j.yaml", *args)
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml"
                                                  ).read_bytes()
    back = tfs.read_cam_pars(tmp_path / "t.yaml")
    for k in ("actR", "actT", "K1", "K2"):
        np.testing.assert_array_equal(back[k], cp[k])
