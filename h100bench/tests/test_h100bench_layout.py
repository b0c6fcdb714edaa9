"""The benchmark's files: BENCHMARK.json keeps the contract's shape, every
name in it has its file, and a cell, configuration or metric added as
files runs with no code edited."""

from __future__ import annotations

import json
import re
import subprocess
import sys

from h100bench import run
from h100bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = tiny.read(tiny.ROOT / "BENCHMARK.json")


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"] and BENCH["command"][1] == "h100bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = tiny.read(tiny.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        mix = tiny.read(tiny.HERE / "traffic" / f"{w['traffic']}.json")
        assert (tiny.HERE / "entries" / f"{mix['entry']}.py").exists()
        assert (tiny.HERE / "limits" / f"{w['name']}.json").exists()
        e2e, per_layer = run.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 3 and per_layer
        reported = {m["name"] for m in e2e}
        assert all(m["moves"] in reported for m in per_layer)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (tiny.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_an_added_cell_and_metric_run_with_no_code_edited(tmp_path):
    bench = tiny.make(tmp_path)
    # a configuration, a traffic mix, a cell and a metric, each added as files
    tiny.write(tmp_path / "configs" / "tiny-wide.json", tiny.tiny_config(name="tiny-wide",
                                                                          intermediate_size=256))
    mix = tiny.read(tmp_path / "traffic" / "tiny-serve.json")
    mix["batch"] = 4
    tiny.write(tmp_path / "traffic" / "tiny-serve-b4.json", mix)
    tiny.write(tmp_path / "limits" / "tiny-wide-serve.json",
               tiny.read(tmp_path / "limits" / "tiny-serve.json"))
    (tmp_path / "metrics" / "serve.calls_in_window.py").write_text(
        "def read(run):\n    return float(run.window['attempted'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny-wide"))
    bench["workloads"].append(dict(name="tiny-wide-serve", config="tiny-wide",
                                   traffic="tiny-serve-b4", chips=1, why="an added cell"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-serve" in m["workloads"]:
            m["workloads"].append("tiny-wide-serve")
    bench["end_to_end"].append({"name": "serve.calls_in_window", "unit": "calls",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-wide-serve"]})
    out = run.run_cell(bench, "tiny-wide-serve", 3, 1.0, False, "cpu", 0.0, tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["serve.calls_in_window"]["value"] == out["attempted"] >= 1
    assert {"docs_per_s", "batch_p95_ms", "setup_s"} <= set(out["metrics"])


def test_without_a_card_the_run_prints_no_result():
    proc = subprocess.run([sys.executable, str(tiny.HERE / "run.py"), "--workload",
                           "v3base-serve-b64", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=tiny.ROOT, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
