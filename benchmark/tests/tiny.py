"""A copy of the benchmark in a temporary directory with cells cut to a
size the CPU runs, for the tests: only data files are added, no harness
file changes.  A configuration's cut is ``tests/cuts/<config>.json``
where there is one, and otherwise the program's ``tiny`` test backbone."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3,
               "window_loss_gap": 1e-4, "window_grad_gap": 1e-3,
               "window_update_gap": 1e-3, "rpn_gap": 1e-4,
               "propose_mismatch": 0, "head_gap": 1e-4, "post_mismatch": 0,
               "repeat_mismatch": 0, "entries_not_followed": 0}


def tiny_config(name: str, bench: str = BENCH) -> dict:
    """``name``'s configuration cut for the CPU, in f32 at 64x96: its cut
    file ``tests/cuts/<name>.json`` (group -> fields, set over the
    configuration, the canvas included) where there is one, else the tiny
    backbone with a 32-channel discriminator."""
    with open(os.path.join(bench, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cut_file = os.path.join(bench, "tests", "cuts", name + ".json")
    cut = {"model": {"backbone": "tiny"}, "adapt": {"d_channels": 32}}
    if os.path.exists(cut_file):
        with open(cut_file) as f:
            cut = json.load(f)
    cfg["name"] = "tiny_" + name
    cfg["model"]["compute_dtype"] = "float32"
    cfg["test"]["bf16_weights"] = False
    cfg["data"].update(image_size=[64, 96], scale=64, max_size=96)
    for group, fields in cut.items():
        cfg[group].update(fields)
    return cfg


def tiny_traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        t = json.load(f)
    t["scene_hw"] = [128, 192]
    t["pool"] = min(t["pool"], 4)
    if "target_pool" in t:
        t["target_pool"] = 4
    t["trace_units"] = 1
    return t


def tiny_root(tmp: str, limits=None) -> str:
    """A checkout of ``BENCHMARK.json`` and ``benchmark/`` at ``tmp``, with
    one ``tiny_<cell>`` cell beside each cell (same traffic kind, tiny
    configuration, a cut mix and ``limits``).  Returns the root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in list(bench["configs"]):
        name = "tiny_" + c["name"]
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(tiny_config(c["name"], os.path.join(root, "benchmark")), f)
        bench["configs"].append({**c, "name": name, "file": path,
                                 "reduced": ["model", "data"]})
    for w in list(bench["workloads"]):
        cell = "tiny_" + w["name"]
        mix = "tiny_" + w["traffic"]
        with open(os.path.join(root, "benchmark", "traffic", mix + ".json"), "w") as f:
            json.dump(tiny_traffic(w["traffic"]), f)
        bench["workloads"].append({**w, "name": cell, "config": "tiny_" + w["config"],
                                   "traffic": mix})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(cell)
        with open(os.path.join(root, "benchmark", "limits", cell + ".json"), "w") as f:
            json.dump({"limits": dict(limits or TINY_LIMITS)}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root
