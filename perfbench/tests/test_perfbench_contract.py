"""The benchmark's files against its contract: BENCHMARK.json's shape,
the result line's keys, cells found by name from data files only, and
imports (nothing of JAX or the JAX package anywhere in perfbench/,
nothing of the program in the reference)."""
import ast
import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

import pb_tiny
from perfbench import harness, spec

ROOT = pb_tiny.ROOT
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert f["source"] == c["source"]
        for key in c["reduced"]:
            assert key in f["model"] and key in f["source_values"]
        # where the port runs another value than the source, the file
        # holds the source's and names the difference, outside reduced
        for key, d in f.get("port_differences", {}).items():
            assert key not in c["reduced"] and set(d) == {"source", "runs",
                                                         "why"}
            assert f["model"].get(key) == d["source"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "limits" / f"{w['name']}.json").exists()
        cell = spec.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} == e2e
        assert cell.per_layer
    for m in b["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    cell = pb_tiny.tiny_cell()
    line = json.loads(json.dumps(harness.execute(
        cell, 2 ** 33 + 1, 0.3, trace, "cpu", time.time(),
        log=lambda *a: None)))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, limits, metric reader and
    workload entry are found by name; no file already there changes
    except BENCHMARK.json's lists."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "mistral-nemo-12b.json").read_text())
    cfg["name"] = "nemo-other"
    (pb / "configs" / "nemo-other.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "longbench_qa32.json").read_text())
    tr["prompt_len"]["tasks"] += tr["prompt_len"]["tasks"][:2]
    tr["requests_per_call"] = 8
    (pb / "traffic" / "longdoc_b8.json").write_text(json.dumps(tr))
    (pb / "limits" / "other.longdoc8.json").write_text(
        (pb / "limits" / "nemo12b.longdoc.json").read_text())
    (pb / "metrics" / "calls.py").write_text(
        "def read(ctx):\n    return len(ctx.window.records)\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({**b["configs"][0], "name": "nemo-other",
                         "file": "perfbench/configs/nemo-other.json"})
    b["workloads"].append({"name": "other.longdoc8", "config": "nemo-other",
                           "traffic": "longdoc_b8", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "ttft_s",
                           "workloads": ["other.longdoc8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("other.longdoc8", root=tmp_path)
    assert cell.traffic["requests_per_call"] == 8
    assert cell.config["name"] == "nemo-other"
    assert [m["name"] for m in cell.per_layer][-1] == "calls"
    reader = spec.metric_reader("calls", here=pb)

    class Ctx:
        class window:
            records = [1, 2, 3]
    assert reader(Ctx) == 3
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())
    assert "nemo12b.longdoc" not in [m.get("workloads", [None])[0]
                                     for m in cell.per_layer[-1:]]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_imports():
    files = sorted(PB.rglob("*.py"))
    assert files
    for f in files:
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
        if "reference" in f.relative_to(PB).parts:
            assert "repro_torch" not in tops and "perfbench" not in tops, f


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "reprox_like", types.ModuleType("x"))
    loaded = {m.split(".")[0] for m in sys.modules} & FORBIDDEN
    assert set(harness.forbidden_modules()) == loaded
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("x"))
    assert "jaxlib" in harness.forbidden_modules()
