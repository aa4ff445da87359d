"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its correctness check
(``limits/<cell>.json``), the readers of its per-layer metrics
(``metrics/<metric>.py``) and the plain reference of its configuration
(``reference/<module>.py``, the module the configuration's ``"reference"``
names, default ``model``). A later cell adds files; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
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
    "num_experts": "num_experts",
    "mamba_d_state": "mamba_d_state",
    "mamba_d_conv": "mamba_d_conv",
    "mamba_expand": "mamba_expand",
    "mamba_dt_rank": "mamba_dt_rank",
    "attn_layer_period": "attn_every",
    "expert_layer_period": "moe_every",
}
# what the port fixes: the file's model, with its port_differences, has to
# run these values
PORT_FIXED = {"rms_norm_eps": 1e-6, "hidden_act": "silu"}
# keys of a source's config that state no shape of a run
NO_RUN_SHAPE = {"max_position_embeddings"}


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
    here: Path = HERE     # the benchmark's package the files came from


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
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        here=here)


def run_model(config: dict) -> dict:
    """The model as it is run: the source's values (``model``) with each of
    ``port_differences`` replaced by the value the port ``runs``."""
    return {**config["model"], **{k: d["runs"] for k, d in
                                  config.get("port_differences", {}).items()}}


def model_config(config: dict):
    """The port's ModelConfig as the configuration file states it: the
    registry entry ``port_arch`` with every key of ``run_model`` applied
    (``MODEL_KEYS``, and the file's own ``"port_keys"``: {source key:
    ModelConfig field}), the keys the port fixes checked; a key that is
    none of these, nor one of ``NO_RUN_SHAPE``, raises."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    m = run_model(config)
    for key, want in PORT_FIXED.items():
        if m.get(key) != want:
            raise ValueError(f"{config['name']}: {key} {m.get(key)!r}; the "
                             f"port runs {want!r} only")
    keys = {**MODEL_KEYS, **config.get("port_keys", {})}
    unknown = sorted(set(m) - set(keys) - set(PORT_FIXED) - NO_RUN_SHAPE)
    if unknown:
        raise ValueError(f"{config['name']}: the port applies no key "
                         f"{', '.join(unknown)}; map each to a ModelConfig "
                         f"field in \"port_keys\"")
    over: dict = {}
    for key, field in keys.items():
        if key in m:
            if field in over and over[field] != m[key]:
                raise ValueError(f"{config['name']}: two keys set {field} "
                                 f"to {over[field]!r} and {m[key]!r}")
            over[field] = m[key]
    if over.get("sliding_window") is None:
        over["sliding_window"] = 0
    return replace(get_arch(config["port_arch"]), **over)


def cache_config(config: dict):
    from repro_torch.configs import CacheConfig
    return CacheConfig(**config["cache"])


def reference(config: dict, here: Path = HERE):
    """The ``Reference`` class of ``reference/<module>.py``, the module the
    configuration's ``"reference"`` names (default ``model``), loaded as
    ``perfbench.reference.<module>`` (so that it may import its siblings
    relatively) from ``here``, unless a module of that name is loaded."""
    name = f"perfbench.reference.{config.get('reference', 'model')}"
    if name not in sys.modules:
        importlib.import_module("perfbench.reference")
        spec = importlib.util.spec_from_file_location(
            name, here / "reference" / f"{name.rsplit('.', 1)[1]}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name].Reference


def metric_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``, loaded by its file name."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
