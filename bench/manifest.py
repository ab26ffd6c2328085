"""Reading `BENCHMARK.json` and the files it names.

A cell (`workloads` entry) names a configuration and a traffic mix; each
is a JSON file found by name. A configuration file holds the published
sizes under the published config's keys, as they are run, plus a `port`
group with what the port's `ModelConfig` needs beyond them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config_file(manifest: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / config_entry(manifest, name)["file"])
                      .read_text())


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_limits(workload: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload}.json").read_text())


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): the entries that list it, or that list no cells."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The `read(run)` function of `bench/metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(cfile: dict, base):
    """The port's `ModelConfig` of a configuration file: `base` (the
    port's registered config of `cfile["arch"]`) with every size taken
    from the file, so the file is what runs."""
    port = cfile["port"]
    kw = dict(
        name=cfile["arch"], family=port["family"],
        num_layers=cfile["num_hidden_layers"], d_model=cfile["hidden_size"],
        num_heads=cfile["num_attention_heads"],
        num_kv_heads=cfile["num_key_value_heads"],
        head_dim=cfile["head_dim"], d_ff=cfile["intermediate_size"],
        vocab_size=cfile["vocab_size"], mlp_kind=port["mlp_kind"],
        norm_kind=port["norm_kind"], rope_kind=port["rope_kind"],
        rope_theta=float(cfile["rope_theta"]),
        tie_embeddings=bool(cfile["tie_word_embeddings"]))
    if "num_local_experts" in cfile:
        kw["moe"] = dataclasses.replace(
            base.moe, num_experts=cfile["num_local_experts"],
            top_k=cfile["num_experts_per_tok"],
            expert_ff=cfile["intermediate_size"],
            capacity_factor=port["moe_capacity_factor"],
            group_size=port["moe_group_size"])
    else:
        kw["moe"] = None
    return dataclasses.replace(base, **kw)
