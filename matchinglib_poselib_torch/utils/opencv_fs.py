"""OpenCV FileStorage reader and writer (yaml / xml, optionally .gz),
numpy only (the port's own copy of ``utils/opencv_fs.py``).

Reads the SemiRealSequence frame data the reference's GT-evaluation CLI
consumes (noMatch_poselib-test/loadMatches.h: readMatchesFromDisk
:41-110, readCamParsFromDisk :223; file naming main.cpp:1522-1543:
``sequSingleFrameData_<n>.<ext>`` + ``matchSingleFrameData_<n>.<ext>``,
ext yaml/yml/xml with optional .gz) without OpenCV:

- scalars (int / float / str) and flat numeric sequences;
- cv::Mat nodes (``!!opencv-matrix`` YAML tag / ``type_id="opencv-matrix"``
  XML attribute) -> numpy arrays, and sequences of them;
- vector<cv::KeyPoint> (7 values per keypoint) -> (N, 7) float arrays
  [x, y, size, angle, response, octave, class_id];
- vector<cv::DMatch> (4 values per match) -> (M, 4) float arrays
  [queryIdx, trainIdx, imgIdx, distance].

``sequ_frame`` assembles one frame's correspondences, GT pose and GT
inlier mask from the two readers' output. The writers (``write_filestorage``,
``write_cam_pars``, ``write_matches``) emit the YAML flavor byte for byte as
the JAX package's writers do.
"""

from __future__ import annotations

import gzip
import io
import pathlib
import re
from typing import Any

import numpy as np

_DT_TO_NP = {
    "u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
    "i": np.int32, "f": np.float32, "d": np.float64,
}
_NP_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NP.items()}


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _read_text(path) -> str:
    raw = pathlib.Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":  # gzip magic (any .gz extension)
        raw = gzip.decompress(raw)
    return raw.decode("utf-8")


class _OpenCVMatrix(dict):
    """Marker for a YAML node tagged !!opencv-matrix."""


def _yaml_to_value(node: Any) -> Any:
    if isinstance(node, _OpenCVMatrix):
        return _mat_from_fields(node)
    if isinstance(node, dict):
        return {k: _yaml_to_value(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_yaml_to_value(v) for v in node]
    return node


def _mat_from_fields(d: dict) -> np.ndarray:
    rows = int(d["rows"])
    cols = int(d["cols"])
    dt = str(d["dt"])
    # dt may carry a channel count suffix like "3u" prefix digits ("2d"
    # means 2-channel double); OpenCV writes "<n><t>"
    m = re.fullmatch(r"(\d*)([ucwsifd])", dt)
    if not m:
        raise ValueError(f"unsupported opencv-matrix dt: {dt!r}")
    ch = int(m.group(1)) if m.group(1) else 1
    np_t = _DT_TO_NP[m.group(2)]
    data = np.asarray(d["data"], dtype=np_t)
    if ch == 1:
        return data.reshape(rows, cols)
    return data.reshape(rows, cols, ch)


def _load_yaml(text: str) -> dict:
    import yaml

    # OpenCV <= 4.x emits the nonstandard directive "%YAML:1.0" which
    # strict parsers reject; drop all directive lines.
    lines = [ln for ln in text.splitlines() if not ln.startswith("%")]
    text = "\n".join(lines)

    class _Loader(yaml.SafeLoader):
        pass

    def _mat(loader, node):
        return _OpenCVMatrix(loader.construct_mapping(node, deep=True))

    _Loader.add_constructor("tag:yaml.org,2002:opencv-matrix", _mat)
    _Loader.add_constructor("!opencv-matrix", _mat)
    # unknown tags: best-effort map/seq/scalar
    def _any(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    _Loader.add_multi_constructor("tag:yaml.org,2002:", _any)
    _Loader.add_multi_constructor("!", _any)
    doc = yaml.load(text, Loader=_Loader)
    if doc is None:
        return {}
    return {k: _yaml_to_value(v) for k, v in doc.items()}


_NUM = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)$")


def _scalar(tok: str):
    if _NUM.match(tok):
        if "." in tok or "e" in tok or "E" in tok:
            return float(tok)
        return int(tok)
    return tok.strip('"')


def _xml_to_value(el) -> Any:
    if el.get("type_id") == "opencv-matrix":
        fields = {c.tag: _xml_to_value(c) for c in el}
        return _mat_from_fields(fields)
    children = list(el)
    if children:
        if all(c.tag == "_" for c in children):
            return [_xml_to_value(c) for c in children]
        return {c.tag: _xml_to_value(c) for c in children}
    text = (el.text or "").strip()
    if not text:
        return []
    toks = text.split()
    if len(toks) == 1:
        return _scalar(toks[0])
    vals = [_scalar(t) for t in toks]
    if all(isinstance(v, (int, float)) for v in vals):
        return vals
    return " ".join(toks).strip('"')


def _load_xml(text: str) -> dict:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(text)
    assert root.tag == "opencv_storage", root.tag
    return {el.tag: _xml_to_value(el) for el in root}


def load_filestorage(path) -> dict:
    """Read a cv::FileStorage yaml/yml/xml(.gz) file into a plain dict."""
    text = _read_text(path)
    if text.lstrip().startswith("<?xml") or text.lstrip().startswith(
        "<opencv_storage"
    ):
        return _load_xml(text)
    return _load_yaml(text)


# ---------------------------------------------------------------------------
# typed views of the SemiRealSequence structures
# ---------------------------------------------------------------------------


def keypoints_array(node) -> np.ndarray:
    """vector<KeyPoint> node -> (N, 7) float32 [x y size angle resp oct id].

    OpenCV's features2d persistence writes keypoints as a flat numeric
    sequence of 7 values per keypoint.
    """
    a = np.asarray(node, np.float32).ravel()
    if a.size % 7:
        raise ValueError(f"keypoint stream length {a.size} not divisible by 7")
    return a.reshape(-1, 7)


def dmatch_array(node) -> np.ndarray:
    """vector<DMatch> node -> (M, 4) float32 [query train img distance]."""
    a = np.asarray(node, np.float32).ravel()
    if a.size % 4:
        raise ValueError(f"dmatch stream length {a.size} not divisible by 4")
    return a.reshape(-1, 4)


def read_cam_pars(path) -> dict:
    """readCamParsFromDisk parity (loadMatches.h:223-246)."""
    d = load_filestorage(path)
    return {
        "actFrameCnt": int(d.get("actFrameCnt", 0)),
        "actR": np.asarray(d["actR"], np.float64),
        "actT": np.asarray(d["actT"], np.float64).reshape(3),
        "K1": np.asarray(d["K1"], np.float64),
        "K2": np.asarray(d["K2"], np.float64),
        "actKd1": np.asarray(d["actKd1"], np.float64),
        "actKd2": np.asarray(d["actKd2"], np.float64),
    }


def read_matches(path) -> dict:
    """readMatchesFromDisk parity (loadMatches.h:120-221)."""
    d = load_filestorage(path)
    out = {
        "frameKeypoints1": keypoints_array(d["frameKeypoints1"]),
        "frameKeypoints2": keypoints_array(d["frameKeypoints2"]),
        "frameDescriptors1": np.asarray(d["frameDescriptors1"]),
        "frameDescriptors2": np.asarray(d["frameDescriptors2"]),
        "frameMatches": dmatch_array(d["frameMatches"]),
        "frameInliers": np.asarray(d["frameInliers"], np.int64).astype(bool),
        "frameKeypoints2NoErr": keypoints_array(d["frameKeypoints2NoErr"]),
        "frameHomographies": [
            np.asarray(m, np.float64) for m in d.get("frameHomographies", [])
        ],
        "frameHomographiesCam1": [
            np.asarray(m, np.float64)
            for m in d.get("frameHomographiesCam1", [])
        ],
        "srcImgPatchKp1": keypoints_array(d.get("srcImgPatchKp1", [])),
        "srcImgPatchKpImgIdx1": np.asarray(
            d.get("srcImgPatchKpImgIdx1", []), np.int64
        ),
        "srcImgPatchKp2": keypoints_array(d.get("srcImgPatchKp2", [])),
        "srcImgPatchKpImgIdx2": np.asarray(
            d.get("srcImgPatchKpImgIdx2", []), np.int64
        ),
        "corrType": np.asarray(d.get("corrType", []), np.int64),
    }
    return out


def sequ_frame(cam_pars: dict, matches: dict) -> dict:
    """Assemble the npz-style frame dict the nomatch CLI evaluates.

    Maps the reference structures onto (pts1, pts2, R_GT, t_GT, K1, K2,
    inlier_mask_GT): match i pairs frameKeypoints1[queryIdx] with
    frameKeypoints2[trainIdx] (matches are sorted by descriptor distance,
    loadMatches.h:64-66); the GT-inlier flag rides on the cam-1 feature
    (frameInliers, loadMatches.h:67-68).
    """
    m = matches["frameMatches"]
    q = m[:, 0].astype(np.int64)
    t = m[:, 1].astype(np.int64)
    pts1 = matches["frameKeypoints1"][q, :2]
    pts2 = matches["frameKeypoints2"][t, :2]
    inl = matches["frameInliers"]
    return {
        "pts1": pts1.astype(np.float32),
        "pts2": pts2.astype(np.float32),
        "R_GT": cam_pars["actR"],
        "t_GT": cam_pars["actT"],
        "K1": cam_pars["actKd1"],
        "K2": cam_pars["actKd2"],
        "K1_GT": cam_pars["K1"],
        "K2_GT": cam_pars["K2"],
        "inlier_mask_GT": inl[q] if inl.size else np.ones(len(q), bool),
    }


# ---------------------------------------------------------------------------
# writing (yaml flavor, byte-compatible with cv::FileStorage readers)
# ---------------------------------------------------------------------------


def _fmt_num(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    f = float(v)
    if f == int(f) and abs(f) < 1e16:
        return f"{int(f)}."
    return repr(f)


def _write_node(buf: io.StringIO, key: str, val: Any, indent: int = 0):
    pad = " " * indent
    if isinstance(val, np.ndarray) and val.ndim == 2:
        dt = _NP_TO_DT.get(val.dtype, "d")
        buf.write(f"{pad}{key}: !!opencv-matrix\n")
        buf.write(f"{pad}   rows: {val.shape[0]}\n")
        buf.write(f"{pad}   cols: {val.shape[1]}\n")
        buf.write(f'{pad}   dt: {dt}\n')
        data = ", ".join(_fmt_num(x) for x in val.ravel())
        buf.write(f"{pad}   data: [ {data} ]\n")
    elif isinstance(val, (list, tuple, np.ndarray)):
        flat = np.asarray(val).ravel() if isinstance(val, np.ndarray) else val
        if len(flat) and isinstance(flat[0], np.ndarray):
            buf.write(f"{pad}{key}:\n")
            ip = " " * (indent + 3)
            for m in flat:
                m = np.asarray(m)
                dt = _NP_TO_DT.get(m.dtype, "d")
                data = ", ".join(_fmt_num(x) for x in m.ravel())
                buf.write(f"{ip}- !!opencv-matrix\n")
                buf.write(f"{ip}   rows: {m.shape[0]}\n")
                buf.write(f"{ip}   cols: {m.shape[1]}\n")
                buf.write(f"{ip}   dt: {dt}\n")
                buf.write(f"{ip}   data: [ {data} ]\n")
        else:
            data = ", ".join(_fmt_num(x) for x in flat)
            buf.write(f"{pad}{key}: [ {data} ]\n")
    elif isinstance(val, str):
        buf.write(f'{pad}{key}: "{val}"\n')
    else:
        buf.write(f"{pad}{key}: {_fmt_num(val)}\n")


def write_filestorage(path, nodes: dict):
    """Write a dict as OpenCV-YAML; gzip if path ends with .gz.

    Matrices -> !!opencv-matrix, lists of matrices -> seq of matrices,
    flat numeric lists -> flow sequences. (N, 7)/(N, 4) float arrays for
    keypoints/matches must be passed pre-flattened by the caller via
    ``.ravel()`` to match OpenCV's flat persistence encoding.
    """
    buf = io.StringIO()
    buf.write("%YAML:1.0\n---\n")
    for k, v in nodes.items():
        _write_node(buf, k, v)
    raw = buf.getvalue().encode()
    p = pathlib.Path(path)
    if p.suffix == ".gz":
        p.write_bytes(gzip.compress(raw))
    else:
        p.write_bytes(raw)


def write_cam_pars(path, actFrameCnt, actR, actT, K1, K2, actKd1, actKd2):
    write_filestorage(path, {
        "actFrameCnt": int(actFrameCnt),
        "actR": np.asarray(actR, np.float64).reshape(3, 3),
        "actT": np.asarray(actT, np.float64).reshape(3, 1),
        "K1": np.asarray(K1, np.float64),
        "K2": np.asarray(K2, np.float64),
        "actKd1": np.asarray(actKd1, np.float64),
        "actKd2": np.asarray(actKd2, np.float64),
    })


def write_matches(path, kp1, kp2, desc1, desc2, matches, inliers,
                  kp2_noerr=None, homographies=(), homographies_cam1=(),
                  src_kp1=None, src_idx1=(), src_kp2=None, src_idx2=(),
                  corr_type=()):
    """Write a matchSingleFrameData file. kp1/kp2: (N, 7), matches: (M, 4)."""
    kp1 = np.asarray(kp1, np.float32)
    kp2 = np.asarray(kp2, np.float32)
    if kp2_noerr is None:
        kp2_noerr = kp2
    if src_kp1 is None:
        src_kp1 = np.zeros((0, 7), np.float32)
    if src_kp2 is None:
        src_kp2 = np.zeros((0, 7), np.float32)
    write_filestorage(path, {
        "frameKeypoints1": kp1.ravel(),
        "frameKeypoints2": kp2.ravel(),
        "frameDescriptors1": np.asarray(desc1),
        "frameDescriptors2": np.asarray(desc2),
        "frameMatches": np.asarray(matches, np.float32).ravel(),
        "frameInliers": np.asarray(inliers).astype(np.int32),
        "frameKeypoints2NoErr": np.asarray(kp2_noerr, np.float32).ravel(),
        "frameHomographies": [np.asarray(h, np.float64)
                              for h in homographies],
        "frameHomographiesCam1": [np.asarray(h, np.float64)
                                  for h in homographies_cam1],
        "srcImgPatchKp1": np.asarray(src_kp1, np.float32).ravel(),
        "srcImgPatchKpImgIdx1": np.asarray(src_idx1, np.int32),
        "srcImgPatchKp2": np.asarray(src_kp2, np.float32).ravel(),
        "srcImgPatchKpImgIdx2": np.asarray(src_idx2, np.int32),
        "corrType": np.asarray(corr_type, np.int32),
    })
