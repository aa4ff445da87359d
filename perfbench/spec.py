"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its correctness check
(``limits/<cell>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A later cell adds files; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the configuration file's keys (the source's names) -> ModelConfig fields
MODEL_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "sliding_window": "sliding_window",
    "num_local_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "moe_capacity_factor": "moe_capacity_factor",
    "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype",
}
# what the port fixes: the file's model, with its port_differences, has to
# run these values
PORT_FIXED = {"rms_norm_eps": 1e-6, "hidden_act": "silu"}


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              here: Path | None = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files from
    ``here`` (default: the package beside ``root``'s benchmark)."""
    here = here or root / "perfbench"
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        config=_read(here / "configs" / f"{w['config']}.json"),
        traffic=_read(here / "traffic" / f"{w['traffic']}.json"),
        limits=_read(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def run_model(config: dict) -> dict:
    """The model as it is run: the source's values (``model``) with each of
    ``port_differences`` replaced by the value the port ``runs``."""
    return {**config["model"], **{k: d["runs"] for k, d in
                                  config.get("port_differences", {}).items()}}


def model_config(config: dict):
    """The port's ModelConfig as the configuration file states it: the
    registry entry ``port_arch`` with every key of ``run_model`` applied,
    the keys the port fixes checked."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    m = run_model(config)
    for key, want in PORT_FIXED.items():
        if m.get(key) != want:
            raise ValueError(f"{config['name']}: {key} {m.get(key)!r}; the "
                             f"port runs {want!r} only")
    over = {field: m[key] for key, field in MODEL_KEYS.items() if key in m}
    if over.get("sliding_window") is None:
        over["sliding_window"] = 0
    return replace(get_arch(config["port_arch"]), **over)


def cache_config(config: dict):
    from repro_torch.configs import CacheConfig
    return CacheConfig(**config["cache"])


def metric_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``, loaded by its file name."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
