"""BENCHMARK.json and the files it names: every cell loads from data, every
name and unit keeps to its characters, and a new file adds a cell or a
metric without an edit to any file already there."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.lib import spec
from benchmark.lib.spec import NAME, UNIT

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    full_check = 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert full_check <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_from_data(cell):
    c = spec.load_cell(cell)
    assert c.kind and spec.runner(c.kind).run
    assert c.limits["limits"]
    for m in c.per_layer:
        assert spec.reader(m["name"]).read
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("what", ["configs", "workloads", "metrics"])
def test_names_units_and_entries(what):
    entries = METRICS if what == "metrics" else BENCH[what]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if what == "metrics":
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert set(e) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
            if "bound" in e:
                assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
            else:
                assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
                assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]} and 0 < len(e["layer"]) <= 200
            assert set(e.get("workloads", CELLS)) <= set(CELLS)
        elif what == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"} and e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and 0 < len(e["why"]) <= 200
        else:
            assert set(e) == {"name", "source", "file", "reduced", "why"} and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"]) and 0 < len(e["why"]) <= 200
            assert e["file"].startswith("benchmark/") and spec.load_json(spec.ROOT / e["file"])["name"] == e["name"]


def test_each_per_layer_metric_is_reported_where_it_moves_something():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS)), m["name"]


def test_kernel_classes_are_files_of_fragments():
    classes = spec.kernel_classes()
    assert {"attention", "depthwise", "elementwise", "optimizer"} <= set(classes)
    assert all(classes.values())


@pytest.mark.parametrize("added", ["cell", "metric", "kernel_class"])
def test_a_new_file_adds_without_editing(tmp_path, added):
    """A copy of the benchmark's folder gains a cell, a reader or a kernel
    class by a new file alone; every file it had stays as it was."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    if added == "cell":
        (bench_dir / "traffic" / "corpus_k8.json").write_text(json.dumps({**spec.load_json(
            bench_dir / "traffic" / "corpus_k4.json"), "steps_per_window": 8}))
        (bench_dir / "limits" / "b5.train.corpus_k8.json").write_text((bench_dir / "limits" / "b5.train.corpus.json")
                                                                        .read_text())
        bench["workloads"].append({"name": "b5.train.corpus_k8", "config": "b5-unet-config2", "traffic": "corpus_k8",
                                   "chips": 1, "why": "windows of 8"})
        cell = spec.load_cell("b5.train.corpus_k8", bench, bench_dir)
        assert cell.traffic["steps_per_window"] == 8 and cell.kind == "train_corpus"
    elif added == "metric":
        (bench_dir / "metrics" / "gemm_share.py").write_text(
            "def read(summary):\n    return 100.0 * summary['class_s'].get('gemm_conv', 0.0) / summary['device_s']\n")
        assert spec.reader("gemm_share.train", bench_dir).read({"class_s": {"gemm_conv": 1.0}, "device_s": 4.0}) == 25.0
    else:
        (bench_dir / "kernel_classes" / "softmax").mkdir()
        (bench_dir / "kernel_classes" / "softmax" / "aten.txt").write_text("softmax_warp\n")
        assert spec.kernel_classes(bench_dir)["softmax"] == ["softmax_warp"]
    assert all(p.read_bytes() == data for p, data in before.items())
