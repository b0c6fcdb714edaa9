"""PyTorch port, serving: Pipeline.predict_features gives the JAX Pipeline's
label, exit and capacity exit per document."""

import pytest
import torch

from _torch_parity import jax_params, port_model, tiny_configs
from multi_modal_early_exit_tpu.data.datasets import synthetic_documents
from multi_modal_early_exit_tpu.data.features import HashWordTokenizer
from multi_modal_early_exit_tpu.serving import Pipeline as JPipeline
from multi_modal_early_exit_tpu_torch.serving import Pipeline

torch.set_num_threads(2)

LABELS = {i: f"class_{i}" for i in range(4)}


@pytest.fixture(scope="module")
def pipelines():
    jcfg, tcfg = tiny_configs(exits=("text_avg", 1), global_threshold=0.26)
    params, tree = jax_params(jcfg, seed=5)
    # the tail sizing rule gives capacities (16, 8) at batch 16: the second
    # stage runs with fewer rows than the batch
    kwargs = dict(id2label=LABELS, batch_size=16, seq_len=32,
                  exit_distribution={0: 0.5, 1: 0.3, 2: 0.2})
    jp = JPipeline(params, jcfg, **kwargs)
    tp = Pipeline(port_model(tcfg, tree), tcfg, device="cpu", **kwargs)
    return jp, tp


def test_pipeline_matches_jax(pipelines):
    jp, tp = pipelines
    assert tp.capacities == jp.capacities == (16, 8)
    docs = synthetic_documents(19, num_labels=4, seq_len=32, image_size=32, seed=3,
                               tokenizer=HashWordTokenizer(vocab_size=1024))
    batch = {k: docs[k] for k in ("input_ids", "bbox", "attention_mask", "pixel_values")}
    want = jp.predict_features(batch)
    got = tp.predict_features(batch)
    assert len(got) == len(want) == 19  # one full batch + a padded one
    for g, w in zip(got, want):
        for key in ("label", "label_id", "exit", "exit_name", "capacity_exited"):
            assert g[key] == w[key], (key, g, w)
        assert abs(g["confidence"] - w["confidence"]) < 1e-4
    assert tp.metrics()["documents_served"] == 19.0
    assert tp.metrics()["capacity_exit_rate"] == jp.metrics()["capacity_exit_rate"]


def test_predict_from_words_and_images(pipelines):
    from PIL import Image

    _, tp = pipelines
    images = [Image.new("RGB", (64, 48), (255, 255, 255)) for _ in range(3)]
    words = [["invoice", "total", "due"]] * 3
    boxes = [[[10, 10, 60, 30], [70, 10, 140, 30], [10, 40, 60, 70]]] * 3
    results = tp.predict(images, words, boxes)
    assert len(results) == 3
    assert len({(r["label"], r["exit"]) for r in results}) == 1  # same inputs
    assert all(0.0 < r["confidence"] <= 1.0 for r in results)
    from multi_modal_early_exit_tpu_torch.data.ocr import have_tesseract

    if not have_tesseract():  # without words the pages go through OCR
        with pytest.raises(RuntimeError, match="pytesseract is not installed"):
            tp.predict(images)


def test_preprocess_ocrs_pages_without_words(pipelines, monkeypatch):
    """Without words or boxes, ``preprocess`` OCRs each page
    (``data.ocr.apply_tesseract``, monkeypatched here: no tesseract) and
    gives the features that the words and boxes would give, as the JAX
    Pipeline's fallback does."""
    import numpy as np
    from PIL import Image

    from multi_modal_early_exit_tpu.data import ocr as jocr
    from multi_modal_early_exit_tpu_torch.data import ocr as tocr

    jp, tp = pipelines
    images = [Image.new("L", (64, 48), 255 - 40 * i) for i in range(3)]
    words = [["page", str(i), "total"] for i in range(3)]
    boxes = [[[10, 10, 60, 30], [70, 10, 140, 30], [10, 40, 60, 70 + i]] for i in range(3)]
    seen = []

    def fake_ocr(image):
        """The i-th page's words and boxes, i read off its grey level."""
        seen.append(image.mode)
        i = (255 - image.getpixel((0, 0))[0]) // 40
        return words[i], boxes[i]

    monkeypatch.setattr(tocr, "apply_tesseract", fake_ocr)
    monkeypatch.setattr(jocr, "apply_tesseract", fake_ocr)
    got = tp.preprocess(images)
    jgot = jp.preprocess(images)
    want = tp.preprocess(images, words, boxes)
    assert seen == ["RGB"] * 6  # each page converted to RGB before the OCR
    for key in ("input_ids", "bbox", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got[key], np.asarray(jgot[key]))
    assert torch.equal(got["pixel_values"], want["pixel_values"])
