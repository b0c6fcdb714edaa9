"""PyTorch port, host side: features, images, configs, device selection and
the port's import boundary."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from multi_modal_early_exit_tpu.config.exit_config import ExitConfig as JExitConfig
from multi_modal_early_exit_tpu.config.exit_config import parse_exits as j_parse_exits
from multi_modal_early_exit_tpu.data import features as jfeat
from multi_modal_early_exit_tpu.data.images import preprocess_images as j_preprocess
from multi_modal_early_exit_tpu.data.labels import RVL_CDIP_ID2LABEL as J_LABELS
from multi_modal_early_exit_tpu.models.layoutlmv3 import modeling as JM
from multi_modal_early_exit_tpu.models.layoutlmv3.config import (
    LayoutLMv3Config as JLayoutLMv3Config,
)
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig, parse_exits
from multi_modal_early_exit_tpu_torch.data import features as tfeat
from multi_modal_early_exit_tpu_torch.data.images import preprocess_images
from multi_modal_early_exit_tpu_torch.data.labels import RVL_CDIP_ID2LABEL
from multi_modal_early_exit_tpu_torch.models.layoutlmv3 import modeling as TM
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import LayoutLMv3Config
from multi_modal_early_exit_tpu_torch.ops import criteria

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEP = 2.0 / 255.0  # one normalized-pixel step


@pytest.mark.parametrize("shape", [(2, 224, 224, 3), (2, 300, 257, 3), (1, 100, 130, 3)])
def test_preprocess_images_matches_jax(shape):
    """Resize (antialiased when downscaling) + normalize: within 1e-2 of a
    normalized-pixel step (2/255) of jax.image.resize's pipeline."""
    x = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(j_preprocess(x, size=224))
    got = preprocess_images(torch.from_numpy(x), size=224).numpy()
    assert got.shape == want.shape == (shape[0], 3, 224, 224)
    np.testing.assert_allclose(got, want, atol=0.01 * STEP, rtol=0)


def test_convert_words_to_features_bit_equal():
    rng = np.random.default_rng(1)
    words = ["Invoice", "TOTAL:", "1234.50", "a-very-long-word-indeed", 3.0, "due"] * 30
    boxes = [sorted(rng.integers(0, 1000, 4).tolist()) for _ in words]
    for seq_len in (32, 512):
        want = jfeat.convert_words_to_features(
            words, boxes, jfeat.HashWordTokenizer(vocab_size=50265), seq_len)
        got = tfeat.convert_words_to_features(
            words, boxes, tfeat.HashWordTokenizer(vocab_size=50265), seq_len)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_copied_vocabularies_match_jax():
    assert RVL_CDIP_ID2LABEL == J_LABELS
    for ctor in ("base", "tiny"):
        theirs = dataclasses.asdict(getattr(JLayoutLMv3Config, ctor)())
        assert dataclasses.asdict(getattr(LayoutLMv3Config, ctor)()) == theirs
    for spec in ("text_avg,vision_avg,7", ("vision_avg", 1, 4, 8)):
        assert parse_exits(spec) == j_parse_exits(spec)
    mine, theirs = ExitConfig(exits="text_avg,7"), JExitConfig(exits="text_avg,7")
    assert mine.to_dict() == theirs.to_dict()
    assert mine.inference_strategy.get_function() is criteria.max_confidence


def test_visual_bbox_and_position_ids_match_jax():
    cfg, jcfg = LayoutLMv3Config.base(), JLayoutLMv3Config.base()
    np.testing.assert_array_equal(TM.visual_bbox(cfg).numpy(), np.asarray(JM.visual_bbox(jcfg)))
    assert TM.visual_bbox(cfg)[0].tolist() == [1, 1, 999, 999]
    ids = np.array([[0, 5, 9, 2, 1, 1], [0, 7, 2, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        TM.create_position_ids_from_input_ids(torch.from_numpy(ids), 1).numpy(),
        np.asarray(JM.create_position_ids_from_input_ids(ids, 1)),
    )


def test_entry_points_need_a_card_unless_told_cpu():
    from multi_modal_early_exit_tpu_torch.models.ee.model import EEModel, init_ee_params
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import EEModelConfig
    from multi_modal_early_exit_tpu_torch.serving import Pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = EEModelConfig(backbone=LayoutLMv3Config.tiny(), exit=ExitConfig(exits=("text_avg", 1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_ee_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EEModel(cfg)
    model = init_ee_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(model, cfg)
    assert Pipeline(model, cfg, device="cpu").device.type == "cpu"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "multi_modal_early_exit_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    # the command-line path's, the variants', the engine's and profiling's among them
    assert {"cli/train.py", "cli/evaluate.py", "cli/research.py", "config/experiment.py",
            "models/registry.py", "training/checkpoint.py", "utils/seeding.py",
            "utils/wandb_compat.py", "evaluation/plots.py",
            "evaluation/operating_points.py", "models/layoutlmv2/config.py",
            "models/layoutlmv2/modeling.py", "models/layoutlmv2/convert.py",
            "models/ee/engine.py", "utils/profiling.py"} <= {
        p.relative_to(ROOT / "multi_modal_early_exit_tpu_torch").as_posix() for p in files[:-1]}
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
            assert top != "multi_modal_early_exit_tpu", (path, mod)


def _module_level_imports(path: pathlib.Path):
    """Modules imported by statements at a file's top level (not inside a
    function or class body, where an import runs only when it is called)."""
    tree = ast.parse(path.read_text())
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try, ast.With)):  # still module level
            for field in ("body", "orelse", "finalbody", "handlers"):
                stack.extend(getattr(node, field, []) or [])
        elif isinstance(node, ast.ExceptHandler):
            stack.extend(node.body)


def test_port_imports_no_host_only_package_at_module_level():
    """The card's machine has no scikit-learn, HuggingFace datasets or
    transformers, pytesseract or PIL: no module of the port (nor
    chip_smoke.py) imports one at module level, nor matplotlib or wandb; the
    hub builders, OCR, the plots and the CLIs import theirs inside."""
    files = sorted((ROOT / "multi_modal_early_exit_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert any(p.name == "datasets.py" for p in files)
    for path in files:
        for mod in _module_level_imports(path):
            top = mod.split(".")[0]
            assert top not in ("sklearn", "datasets", "pytesseract", "PIL", "transformers",
                               "matplotlib", "wandb"), (path, mod)
