"""A benchmark root at the tiny presets, for the CPU tests: the real
metric readers and traffic mixes, tiny configurations written from the
program's presets, small mixes and cells, and the real cells' limits."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark.harness import spec

BENCH = spec.BENCH
OPTIM = {"lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.01,
         "max_grad_norm": 1.0, "warmup_ratio": 0.03, "total_steps": 10000,
         "warmup_start_factor": 1e-5, "eps": 1e-8}
# tiny cell -> (config, mix, mode, batch, sequence, the real cell it stands
# in for)
CELLS = {
    "ds-serve": ("ds_tiny", "png_small", "serve", 2, 93, "dsvl13b-serve-png"),
    "ln-serve": ("ln_tiny", "png_small", "serve", 2, 128,
                 "llavanext-m7b-serve-png"),
    "ds-train": ("ds_tiny", "mix_small", "train", 2, 93, "dsvl13b-train-mix"),
}
IMAGES = {"values": [[40, 90], [90, 60], [48, 64]],
          "shares": [0.5, 0.25, 0.25]}


def even(values: list) -> dict:
    """A histogram with every value's share alike."""
    return {"values": values, "shares": [1.0] * len(values)}


CONFIGS = {"ds_tiny": ("deepseek_vl", "tiny", "deepseek"),
           "ln_tiny": ("llava_next", "tiny", "llava")}


def make(root: pathlib.Path) -> dict:
    """Write the tiny root and return its manifest."""
    from flmm_tpu_torch import registry

    from benchmark.harness.program import describe

    root = pathlib.Path(root)
    for d in ("configs", "workloads"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics", dirs_exist_ok=True)
    shutil.copytree(BENCH / "traffic", root / "traffic", dirs_exist_ok=True)
    mixes = {
        "png_small": {"phrases": even([1, 2, 3]),
                      "phrase_tokens": even([2, 3, 4]),
                      "narrative_tokens": even([8, 12, 16]),
                      "image_hw": IMAGES},
        "refcoco_small": {"phrases": even([1, 2]),
                          "phrase_tokens": even([2, 3, 4, 5]),
                          "narrative_tokens": None, "image_hw": IMAGES},
        "mix_small": {"parts": [{"traffic": "png_small", "share": 0.5},
                                {"traffic": "refcoco_small", "share": 0.5}]},
    }
    for name, mix in mixes.items():
        (root / f"traffic/{name}.json").write_text(json.dumps(mix))
    for name, (family, preset, rule) in CONFIGS.items():
        cfg = registry.get_config(family, preset)
        base = cfg.base if hasattr(cfg, "base") else cfg
        (root / f"configs/{name}.json").write_text(json.dumps({
            "source": "tiny preset", "family": family, "preset": preset,
            "preset_kwargs": {}, "prompt_img_start": base.img_start,
            "size_rule": rule, "reduced": [], "model": describe(cfg)}))
    manifest = spec.read_json(BENCH.parent / "BENCHMARK.json")
    workloads = []
    for name, (config, mix, mode, batch, seq, real) in CELLS.items():
        limits = spec.read_json(BENCH / f"workloads/{real}.json")["limits"]
        cell = {"config": config, "traffic": mix, "mode": mode,
                "batch": batch, "pool": 4, "seq_len": seq, "max_masks": 3,
                "text_per_mask": 5, "check_requests": 2,
                "trace_requests": 2, "limits": limits}
        if mode == "train":
            cell["optim"] = OPTIM
        (root / f"workloads/{name}.json").write_text(json.dumps(cell))
        workloads.append({"name": name, "config": config, "traffic": mix,
                          "chips": 1, "why": f"tiny stand-in for {real}"})
    real_of = {v[5]: k for k, v in CELLS.items()}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real_of[w] for w in m["workloads"]
                              if w in real_of]
    manifest["workloads"] = workloads
    manifest["configs"] = [{"name": n, "source": "tiny preset",
                            "file": f"configs/{n}.json", "reduced": [],
                            "why": "tiny"} for n in CONFIGS]
    return manifest
