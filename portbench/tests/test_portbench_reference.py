"""The plain references agree with the program on small CPU inputs, and
import nothing of it. Only these tests import the program."""

import ast
import pathlib

import pytest
import torch

from portbench.reference import hamming

REFERENCE = pathlib.Path(hamming.__file__).resolve().parent


def _words(g, n, words=8):
    return torch.randint(0, 256, (n, 4 * words), dtype=torch.uint8,
                         generator=g).view(torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top2_matches_knn2_plain(seed):
    from matchinglib_poselib_torch.ops.kernels.knn2 import knn2_plain

    g = torch.Generator().manual_seed(seed)
    q, db = _words(g, 37), _words(g, 300)
    db[::9] = q[:34]  # exact duplicates: ties at distance 0
    valid = torch.rand(300, generator=g) > 0.2
    d1, d2, idx = hamming.top2(q, db, valid, block=64)
    w1, w2, widx = knn2_plain(q, db, valid)
    assert torch.equal(d1, w1) and torch.equal(d2, w2)
    assert torch.equal(idx.to(torch.int32), widx)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_equals_sharded_match_in_a_world_of_one(seed, monkeypatch):
    import datetime
    import socket

    import torch.distributed as dist

    from matchinglib_poselib_torch.config import LOWE_RATIO
    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel.matching import sharded_match

    g = torch.Generator().manual_seed(seed)
    db = _words(g, 500)
    q = db[torch.randperm(500, generator=g)[:64]].clone()
    q[32:] = _words(g, 32)
    q[:32] ^= _words(g, 32) & _words(g, 32) & _words(g, 32)  # ~1/8 bits
    vq = torch.rand(64, generator=g) > 0.1
    vdb = torch.rand(500, generator=g) > 0.1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = sharded_match(pmesh.make_mesh(1, device="cpu"), q, db, vq, vdb)
    finally:
        dist.destroy_process_group()
    ref = hamming.match(q, vq, db, vdb, LOWE_RATIO)
    for k in ("idx", "distance", "second_distance", "mask"):
        assert torch.equal(getattr(got, k), ref[k].to(getattr(got, k).dtype))
    assert 0 < int(ref["mask"].sum()) < 64


def test_half_the_bits_is_a_control_that_fails():
    g = torch.Generator().manual_seed(4)
    q, db = _words(g, 64), _words(g, 400)
    v = torch.ones(400, dtype=torch.bool)
    full = hamming.match(q, torch.ones(64, dtype=torch.bool), db, v, 0.75)
    half = hamming.match(q, torch.ones(64, dtype=torch.bool), db, v, 0.75,
                         bits=128)
    assert int((full["distance"] != half["distance"]).sum()) > 32


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted(REFERENCE.rglob("*.py"))
    assert REFERENCE / "hamming.py" in files
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in ("matchinglib_poselib_torch", "jax", "jaxlib",
                               "flax", "matchinglib_poselib_tpu"), (f, name)
