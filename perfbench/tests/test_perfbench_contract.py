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
        reported = {m["name"] for m in cell.end_to_end}
        # set-up and at least one more end-to-end metric, a per-layer one,
        # and each per-layer metric moves one that the cell reports
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
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


OWN_REFERENCE = """from .model import Reference as _Model


class Reference(_Model):
    runs = 0

    def run(self, *a, **kw):
        type(self).runs += 1
        return super().run(*a, **kw)
"""


@pytest.mark.parametrize("own_reference", [False, True])
def test_a_cell_is_added_by_files_alone(tmp_path, own_reference):
    """A new configuration, traffic mix, limits, metric reader and
    workload entry are found by name; no file already there changes
    except BENCHMARK.json's lists. With ``own_reference``, a tiny
    configuration names a reference module of its own, written beside
    model.py, and ``run_check`` judges the cell's answers with it."""
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
    if own_reference:
        _check_with_own_reference(tmp_path, pb)
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())
    assert "nemo12b.longdoc" not in [m.get("workloads", [None])[0]
                                     for m in cell.per_layer[-1:]]


def _check_with_own_reference(root: Path, pb: Path):
    from perfbench import check, traffic as tm
    (pb / "reference" / "own_ref.py").write_text(OWN_REFERENCE)
    cfg = {**pb_tiny.tiny_config(), "name": "tiny-own",
           "reference": "own_ref"}
    (pb / "configs" / "tiny-own.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny.json").write_text(
        json.dumps(pb_tiny.tiny_traffic()))
    (pb / "limits" / "tiny.own.json").write_text(json.dumps(pb_tiny.LOOSE))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.own", "config": "tiny-own",
                           "traffic": "tiny", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("tiny.own", root=root)
    Own = spec.reference(cell.config, cell.here)
    assert Own.__module__ == "perfbench.reference.own_ref"
    prog = harness.setup(cell, 5, "cpu")
    call = tm.make_call(cell.traffic, prog.cfg.vocab_size, 5, 0)
    rec = harness.run_call(prog, call, cell.traffic["decode_steps"])
    numbers, picks = check.run_check(prog, cell, 5, [rec])
    assert Own.runs == len(picks) > 0
    assert check.verdict(numbers, cell.limits), numbers


def _model(**extra):
    return {**pb_tiny.tiny_config(), **extra}


def test_hybrid_keys_are_applied():
    cfg = _model(name="tiny-jamba", port_arch="jamba-1.5-large-398b")
    cfg["model"] = {**cfg["model"], "attn_layer_period": 8,
                    "expert_layer_period": 2, "num_experts": 16,
                    "num_local_experts": 16, "num_experts_per_tok": 2,
                    "mamba_d_state": 16, "mamba_d_conv": 4,
                    "mamba_expand": 2, "mamba_dt_rank": 32,
                    "num_hidden_layers": 8}
    mc = spec.model_config(cfg)
    assert (mc.attn_every, mc.moe_every, mc.num_experts, mc.mamba_d_state,
            mc.mamba_d_conv, mc.mamba_expand, mc.mamba_dt_rank) == \
        (8, 2, 16, 16, 4, 2, 32)
    assert [s.mixer for s in mc.layer_specs()].count("attn") == 1


def test_port_keys_map_a_files_own_keys():
    cfg = _model(port_keys={"use_qk_norm": "qk_norm"})
    cfg["model"] = {**cfg["model"], "use_qk_norm": True}
    assert spec.model_config(cfg).qk_norm is True


@pytest.mark.parametrize("key", ["attn_layer_offset", "num_experts"])
def test_an_unmapped_or_conflicting_key_raises(key):
    """A key the port does not apply raises, naming it; so do two keys of
    the source that set one field apart (num_experts against
    num_local_experts)."""
    cfg = _model()
    cfg["model"] = {**cfg["model"], "num_local_experts": 0, key: 4}
    with pytest.raises(ValueError, match=key):
        spec.model_config(cfg)
    cfg["model"].pop(key)
    cfg["model"]["max_position_embeddings"] = 4096     # states no run shape
    spec.model_config(cfg)


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
