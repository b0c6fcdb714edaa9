"""A tiny copy of the benchmark's data for CPU tests: the configuration cut
to LayoutLMv3's tiny sizes, small pools, the metric readers copied, and a
BENCHMARK.json over two tiny cells. f32 throughout unless a test asks for
the configuration's bf16."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

TINY = dict(name="tiny", vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=130, coordinate_size=8, shape_size=16,
            rel_pos_bins=8, max_rel_pos=32, rel_2d_pos_bins=16, max_rel_2d_pos=64, input_size=32,
            patch_size=16, text_len=64, num_labels=4, exits=["text_avg", "vision_avg", 1],
            word_pieces=[4, 1024], serve_dtype="float32", train_compute_dtype="float32")


TRAIN_LIMITS = {"loss_gap": 0.002, "grad_gap": 0.5, "change_gap": 0.15}
METRIC_FILES = sorted(p.stem for p in (HERE / "metrics").glob("*.*.py")
                      if p.stem.split(".")[0] in ("serve", "harvest", "interactive", "train", "v2"))


def read(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


TINY_V2 = dict(name="tiny-v2", vocab_size=1024, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128, max_position_embeddings=130,
               coordinate_size=8, shape_size=16, rel_pos_bins=8, max_rel_pos=32, rel_2d_pos_bins=16,
               max_rel_2d_pos=64, image_feature_pool_shape=[2, 2, 32], input_size=32,
               backbone_depths=[1, 1], backbone_groups=1, backbone_width_per_group=8,
               backbone_stem_channels=8, fpn_channels=32, text_len=64, num_labels=4,
               word_pieces=[4, 1024], serve_dtype="float32")


def tiny_v2_config(**over) -> dict:
    cfg = read(HERE / "configs" / "layoutlmv2-base.json")
    cfg.update(TINY_V2)
    cfg.update(over)
    return cfg


def tiny_config(**over) -> dict:
    cfg = read(HERE / "configs" / "eelayoutlmv3-base.json")
    cfg.update(TINY)
    cfg.update(over)
    return cfg


def make(tmp: Path, **over) -> dict:
    """Write the tiny data under ``tmp``; returns its BENCHMARK object."""
    write(tmp / "configs" / "tiny.json", tiny_config(**over))
    serve = read(HERE / "traffic" / "serve-closed-b64.json")
    serve.update(pool=32, words=[5, 40], batch=8, calibration_docs=32, reference_block=8,
                 check_calls=2, trace_units=1, warmup_calls=1)
    write(tmp / "traffic" / "tiny-serve.json", serve)
    train = read(HERE / "traffic" / "train-b64.json")
    train.update(pool=32, words=[5, 40], batch=8, reference_block=4, trace_units=1)
    write(tmp / "traffic" / "tiny-train.json", train)
    write(tmp / "configs" / "tiny-v2.json", tiny_v2_config())
    harvest = read(HERE / "traffic" / "harvest-b64.json")
    harvest.update(pool=32, words=[5, 40], batch=8, reference_block=8, trace_units=4)
    write(tmp / "traffic" / "tiny-harvest.json", harvest)
    # the serving and harvest cells take their real cells' limits; the
    # training cell, out of BENCHMARK.json while the program's bf16
    # embedding gradient is at fault (PERF.md), takes the readings' loss and
    # change limits and a gradient limit between a sound f32 run and a fault
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    shutil.copy(HERE / "limits" / "v3base-serve-b64.json", tmp / "limits" / "tiny-serve.json")
    shutil.copy(HERE / "limits" / "v2base-harvest-b64.json", tmp / "limits" / "tiny-harvest.json")
    write(tmp / "limits" / "tiny-train.json", TRAIN_LIMITS)
    real = read(ROOT / "BENCHMARK.json")
    metrics = {m["name"]: m for m in real["end_to_end"] + real["per_layer"]}
    e2e = {"tiny-serve": ["docs_per_s", "batch_p95_ms"], "tiny-harvest": ["docs_per_s"],
           "tiny-train": ["train_docs_per_s"]}
    bench = {"configs": [{"name": "tiny"}, {"name": "tiny-v2"}],
             "workloads": [dict(name=n, config="tiny-v2" if n == "tiny-harvest" else "tiny",
                                traffic=n, chips=1, why="a CPU test") for n in e2e],
             "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                             "source": "host_clock"},
                            {"name": "peak_mem_mib", "unit": "MiB", "better": "lower", "bound": 0.01,
                             "source": "host_clock"}],
             "per_layer": []}
    for name in ("docs_per_s", "batch_p95_ms", "train_docs_per_s"):
        bench["end_to_end"].append({"name": name, "unit": "docs/s", "better": "higher", "bound": 0.05,
                                    "source": "host_clock",
                                    "workloads": [c for c, ms in e2e.items() if name in ms]})
    for name in METRIC_FILES:
        moves = "train_docs_per_s" if name.startswith("train.") else "docs_per_s"
        cells = ["tiny-train"] if moves == "train_docs_per_s" else ["tiny-serve", "tiny-harvest"]
        bench["per_layer"].append(dict(metrics.get(name, {"unit": "%", "better": "lower",
                                                          "source": "device_trace", "layer": "x"}),
                                       name=name, moves=moves, workloads=cells))
    shutil.copytree(HERE / "metrics", tmp / "metrics")
    return bench
