"""PyTorch port, the evaluation path's data modules against the JAX
package's: the synthetic datasets (integer columns bit-equal, pixel values
within 1e-6), the device-side band renderer, the batch iterator with its
padded last batch, the device prefetch (on the CPU here), the dataset
registry and the OCR helpers.
"""

import numpy as np
import pytest
import torch

from multi_modal_early_exit_tpu.data import datasets as jds
from multi_modal_early_exit_tpu.data import loader as jloader
from multi_modal_early_exit_tpu.data import ocr as jocr
from multi_modal_early_exit_tpu_torch.data import datasets as tds
from multi_modal_early_exit_tpu_torch.data import loader as tloader
from multi_modal_early_exit_tpu_torch.data import ocr as tocr

INT_COLUMNS = ("input_ids", "bbox", "attention_mask", "labels")


def _same_split(got, want):
    assert got.name == want.name and got.split == want.split
    assert got.id2label == want.id2label and len(got) == len(want)
    assert set(got.arrays) == set(want.arrays)
    for key in INT_COLUMNS:
        assert got.arrays[key].dtype == want.arrays[key].dtype, key
        np.testing.assert_array_equal(got.arrays[key], want.arrays[key], err_msg=key)
    assert got.arrays["pixel_values"].dtype == np.float32
    np.testing.assert_allclose(got.arrays["pixel_values"], want.arrays["pixel_values"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_tiny_synthetic_splits_equal_the_jax_package(split):
    _same_split(tds.build_dataset("synthetic_rvl_cdip_tiny", split),
                jds.build_dataset("synthetic_rvl_cdip_tiny", split))


@pytest.mark.parametrize("difficulty", [0.0, 1.0])
def test_build_synthetic_equals_the_jax_package(difficulty):
    kw = dict(n_eval=6, num_labels=16, seq_len=48, image_size=40, seed=7,
              difficulty=difficulty)
    _same_split(tds.build_synthetic("test", **kw), jds.build_synthetic("test", **kw))


def test_device_band_images_equal_the_host_version():
    ids = np.array([0, 1, 5, 7, 8, 15], np.int32)
    host = tds.synthetic_band_images(ids, 40)
    dev = tds.synthetic_band_images_device(ids, 40, device="cpu")
    assert dev.dtype == torch.uint8 and dev.shape == host.shape
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(host, jds.synthetic_band_images(ids, 40))


@pytest.mark.parametrize("batch_size", [3, 4, 16])
@pytest.mark.parametrize("shuffle", [False, True])
def test_iterate_batches_equals_the_jax_package(batch_size, shuffle):
    """The same batches, the last one padded by repeating rows with
    ``sample_mask`` 0 on the padding, and without padding when asked."""
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "test")  # 8 documents
    for kw in (dict(), dict(pad_final=False), dict(drop_last=True)):
        got = list(tloader.iterate_batches(data, batch_size, shuffle=shuffle, **kw))
        want = list(jloader.iterate_batches(data, batch_size, shuffle=shuffle, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    last = list(tloader.iterate_batches(data, 3))[-1]
    np.testing.assert_array_equal(last["sample_mask"], [1.0, 1.0, 0.0])
    layout = tloader.accumulation_layout(last, 3)
    np.testing.assert_array_equal(layout["labels"],
                                  jloader.accumulation_layout(last, 3)["labels"])


def test_prefetch_to_device_gives_the_same_batches_on_the_cpu():
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "validation")
    want = list(tloader.iterate_batches(data, 3))
    got = list(tloader.prefetch_to_device(tloader.iterate_batches(data, 3), "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), w[key])
    assert list(tloader.prefetch_to_device(iter([]), "cpu")) == []


def test_registry_and_split_indices_equal_the_jax_package():
    for name in ("synthetic_rvl_cdip_tiny", "synthetic_rvl_cdip_hard", "synthetic_x", "rvl_cdip"):
        assert tds.dataset_spec(name) == jds.dataset_spec(name)
    assert set(tds.DATASET_BUILDERS) == set(jds.DATASET_BUILDERS)
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.build_dataset("no_such_dataset", "test")
    for split in ("train", "validation", "test"):
        np.testing.assert_array_equal(tds.tobacco_split_indices(3482, split),
                                      jds.tobacco_split_indices(3482, split))
    data = tds.build_dataset("synthetic_rvl_cdip_tiny", "train")
    sub, jsub = tds.create_subset(data, 2), jds.create_subset(data, 2)
    np.testing.assert_array_equal(sub.arrays["labels"], jsub.arrays["labels"])
    assert len(data.downsample(5)) == 5 and data.num_labels == 4


def test_ocr_helpers():
    """pytesseract is imported only when OCR runs: without it (as on the
    card's machine) ``have_tesseract`` is false and ``apply_tesseract``
    raises; the box normalisation is the JAX package's."""
    assert tocr.have_tesseract() == jocr.have_tesseract()
    if not tocr.have_tesseract():
        with pytest.raises(RuntimeError, match="pytesseract is not installed"):
            tocr.apply_tesseract(None)
    for box, w, h in (([10, 20, 300, 40], 600, 800), ([-5, 0, 900, 1200], 800, 1000)):
        assert tocr.normalize_box(box, w, h) == jocr.normalize_box(box, w, h)
