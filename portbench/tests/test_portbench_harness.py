"""The harness finds configurations, cells, traffic generators, metric
readers and rooflines by name, and prints the contract's line."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SMALL
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e, layer = harness.cell_metrics(BENCH, cell)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_find_cell_by_name(cell):
    c = harness.find_cell(cell, BENCH)
    assert c.config["source"] == next(
        x["source"] for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert hasattr(c.generator, "Driver")
    assert set(c.spec["limits"]) and c.spec["why"] == c.entry["why"]


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path,
                                                            monkeypatch):
    """A later change adds a cell, its configuration and a metric by new
    files under portbench/ and new entries in BENCHMARK.json alone."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="kitti_orb_map_small",
                                 file="portbench/configs/kitti_orb_map_small.json"))
    bench["workloads"].append({"name": "orbmap.small", "config":
                               "kitti_orb_map_small", "traffic": "tiny",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "queries_done", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "Distribution", "moves": "queries_per_s",
                               "workloads": ["orbmap.small"]})
    bench["end_to_end"][0]["workloads"].append("orbmap.small")
    cfg = json.loads((here / "configs" / "kitti_orb_map.json").read_text())
    cfg.update(SMALL["orbmap.seq00"]["config"])
    (here / "configs" / "kitti_orb_map_small.json").write_text(json.dumps(cfg))
    spec = json.loads((here / "workloads" / "orbmap.seq00.json").read_text())
    spec.update(config="kitti_orb_map_small", traffic="tiny",
                why="a test's cell")
    spec["params"].update(SMALL["orbmap.seq00"]["params"])
    (here / "workloads" / "orbmap.small.json").write_text(json.dumps(spec))
    (here / "metrics" / "queries_done.py").write_text(
        "def read(ctx):\n    return ctx.window.units\n")
    monkeypatch.setattr(harness, "HERE", here)
    out = harness.run_cell("orbmap.small", 5, 0.2, True, torch.device("cpu"),
                           bench=bench)
    assert out["correct"] and out["metrics"]["queries_done"]["value"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    out = harness.run_cell("orbmap.seq00", 2**31 + 7, 0.2, trace,
                           torch.device("cpu"), overrides=SMALL["orbmap.seq00"])
    keys = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert out["correct"] is True and out["failed"] == 0
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == dev | ({"busy_s", "window_s"} if trace
                                        else set())
    e2e, layer = harness.cell_metrics(BENCH, "orbmap.seq00")
    names = {m["name"] for m in (layer if trace else e2e)}
    assert set(out["metrics"]) <= names
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_query_repeats_in_a_run(monkeypatch):
    """The warm-up, the window and the traced requests each send a query
    of their own: no input is sent twice in a run."""
    from matchinglib_poselib_torch.parallel import matching as pmatch

    sent = []
    real = pmatch.sharded_match

    def spy(mesh, q, *a, **k):
        sent.append(q.data_ptr())
        return real(mesh, q, *a, **k)
    monkeypatch.setattr(pmatch, "sharded_match", spy)
    out = harness.run_cell("orbmap.seq00", 11, 0.2, True,
                           torch.device("cpu"), overrides=SMALL["orbmap.seq00"])
    assert out["correct"] and out["attempted"] > 1
    assert len(sent) > out["attempted"] + 2
    assert len(set(sent)) == len(sent)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "orbmap.seq00",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_without_the_program_fails(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "harness.run_cell('orbmap.seq00', 1, 0.1, False, "
            "torch.device('cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "matchinglib_poselib_torch" in proc.stderr


def test_roofline_of_a_seq00_query():
    """0.9335 ms a query: the forward 2048 x 9,299,968 and the reverse
    2048 x 2048 at 256 bits, at the b1 tensor-core rate; the product
    binds, not the bytes."""
    k2a = harness.load_module(harness.HERE / "rooflines" / "k2a.py")
    rows = 4541 * 2048
    config = harness.find_cell("orbmap.seq00", BENCH).config
    least = k2a.least_s(config)
    assert round(least * 1e3, 4) == 0.9335
    assert least == k2a.bound_s(2048, rows, 256) + k2a.bound_s(2048, 2048,
                                                                 256)
    assert k2a.ops(2048, rows, 256) / k2a.B1_TENSOR_OPS_S > (
        k2a.bytes_moved(2048, rows, 256) / k2a.HBM_BYTES_S)
