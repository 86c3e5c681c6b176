"""A run whose timed path is broken underneath comes out not correct:
once for each fault the cell can have (its answer altered where it is
produced, a request answered with the last one's state, half of the map
left out), on a small copy of the cell on the CPU. The cell runs in a
world of one, so there is no exchange between chips to leave out."""

import pytest
import torch

from conftest import SMALL
from portbench import harness


def _run(cell):
    return harness.run_cell(cell, 21, 0.1, False, torch.device("cpu"),
                            overrides=SMALL[cell])


def _stale(fn):
    last = {}

    def broken(*a, **k):
        out = fn(*a, **k)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev
    return broken


@pytest.fixture
def sharded(monkeypatch):
    from matchinglib_poselib_torch.parallel import matching as pmatch

    def patch(make):
        monkeypatch.setattr(pmatch, "sharded_match",
                            make(pmatch.sharded_match))
    return patch


def test_orbmap_sound_run_is_correct():
    assert _run("orbmap.seq00")["correct"]


def test_orbmap_altered_answer(sharded):
    def make(fn):
        def broken(*a, **k):
            r = fn(*a, **k)
            return r._replace(idx=r.idx.roll(1))
        return broken
    sharded(make)
    assert not _run("orbmap.seq00")["correct"]


def test_orbmap_stale_answer(sharded):
    sharded(_stale)
    assert not _run("orbmap.seq00")["correct"]


def test_orbmap_half_of_the_map_left_out(sharded):
    def make(fn):
        def broken(mesh, q, db, vq, vdb, **k):
            half = db.shape[0] // 2
            return fn(mesh, q, db[:half], vq, vdb[:half], **k)
        return broken
    sharded(make)
    assert not _run("orbmap.seq00")["correct"]
