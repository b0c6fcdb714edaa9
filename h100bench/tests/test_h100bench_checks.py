"""The output check decides ``correct``: a sound run passes, and a run
whose timed path is broken underneath fails, once for each fault the cell
can have; the control (the reference in float8 in the program's place)
fails too. The tiny cells on the CPU, driven through ``run.run_cell`` with
the look for a card skipped; the limits are the cells' own."""

from __future__ import annotations

import os

import pytest
import torch

from h100bench import run
from h100bench.tests import tiny


@pytest.fixture
def bench(tmp_path):
    return tiny.make(tmp_path), tmp_path


def run_tiny(bench, cell, seed=5):
    b, data = bench
    return run.run_cell(b, cell, seed, 0.3, False, "cpu", 0.0, data)


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_a_sound_run_is_correct(bench, cell):
    out = run_tiny(bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_an_altered_answer_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    real = Pipeline.predict_features

    def altered(self, batch):  # every label moved to the next class
        answers = real(self, batch)
        for a in answers:
            a["label_id"] = (a["label_id"] + 1) % 4
        return answers

    monkeypatch.setattr(Pipeline, "predict_features", altered)
    out = run_tiny(bench, "tiny-serve")
    assert not out["correct"] and over(out, "label_gap")


def over(out, *names) -> bool:
    """Some of ``names`` read above their limits."""
    return any(out["checks"][n]["value"] > out["checks"][n]["limit"] for n in names)


def test_half_a_served_batch_left_out_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    real = Pipeline.predict_features
    monkeypatch.setattr(Pipeline, "predict_features",
                        lambda self, batch: real(self, batch)[: self.batch_size // 2])
    out = run_tiny(bench, "tiny-serve")
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.training.trainer import Optimizer

    monkeypatch.setattr(Optimizer, "apply", lambda self, grads: None)
    out = run_tiny(bench, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_a_training_batch_left_out_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.training.trainer import EETrainer

    real = EETrainer.train_step

    def half(self, batch, rng):
        return real(self, {k: v[:, : v.shape[1] // 2] for k, v in batch.items()}, rng)

    monkeypatch.setattr(EETrainer, "train_step", half)
    out = run_tiny(bench, "tiny-train")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train", "tiny-harvest"])
def test_the_control_reads_far_above_a_sound_run(bench, cell):
    """The control's procedure at a size a CPU test holds: its numbers read
    far above those of a sound (f32) program on the same documents. Its
    readings against the limits are made on the card, below."""
    b, data = bench
    config = {w["name"]: w["config"] for w in b["workloads"]}[cell]
    cfg = tiny.read(data / "configs" / f"{config}.json")
    mix = tiny.read(data / "traffic" / f"{cell}.json")
    entry = run.load_module(tiny.HERE / "entries" / f"{mix['entry']}.py").Entry(
        cfg, mix, 5, "cpu", open(os.devnull, "w"))
    entry.window(0.1)
    sound = entry.check()
    control = entry.control()
    assert any(control[k] > 10 * sound[k] + 1e-3 for k in control), (sound, control)


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size():
    """On the card: the control of each cell, at its own size, fails its
    limits (``python -m pytest h100bench/tests -m cuda`` there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from h100bench import readings

    for cell in ("v3base-serve-b64", "v3base-serve-b16", "v2base-harvest-b64"):
        rows = readings.read_cell(cell, [], [2 ** 31 + 11])
        limits = tiny.read(tiny.HERE / "limits" / f"{cell}.json")
        control = [r for r in rows if r["kind"] == "control"]
        assert control and all(any(k in limits and v > limits[k] for k, v in r["numbers"].items())
                               for r in control), rows


def test_an_altered_exit_decision_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    real = Pipeline.predict_features

    def to_final(self, batch):
        answers = real(self, batch)
        for a in answers:
            a["exit"], a["capacity_exited"] = len(self.order), False
        return answers

    monkeypatch.setattr(Pipeline, "predict_features", to_final)
    out = run_tiny(bench, "tiny-serve")
    assert not out["correct"] and over(out, "exit_err")


def test_a_sound_harvest_is_correct(bench):
    out = run_tiny(bench, "tiny-harvest")
    assert out["correct"], out["checks"]


def test_an_altered_store_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.evaluation import pipeline

    real = pipeline.get_logits

    def altered(*args, **kwargs):
        store, refs, stats = real(*args, **kwargs)
        store[0, 0, 0] += 1.0
        return store, refs, stats

    monkeypatch.setattr(pipeline, "get_logits", altered)
    out = run_tiny(bench, "tiny-harvest")
    assert not out["correct"] and over(out, "store_err")


def test_half_a_harvested_split_left_out_is_caught(bench, monkeypatch):
    from multi_modal_early_exit_tpu_torch.evaluation import pipeline

    real = pipeline.get_logits

    def half(model, cfg, dataset, *args, **kwargs):
        return real(model, cfg, dataset.select(range(len(dataset) // 2)), *args, **kwargs)

    monkeypatch.setattr(pipeline, "get_logits", half)
    out = run_tiny(bench, "tiny-harvest")
    assert not out["correct"] and out["failed"] == out["attempted"]
