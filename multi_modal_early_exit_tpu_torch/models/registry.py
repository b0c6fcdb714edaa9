"""Model registry/builder (parity: ``build_model``, EE/configs.py:361-515).

The port's counterpart of the JAX package's ``models/registry.py``. Model
names and what the port builds for them:

- ``EElayoutlmv3``   early-exit LayoutLMv3 (the flagship)
- ``LTElayoutlmv3``  EE LayoutLMv3 with the learning-to-exit head
                     (``use_lte=True``)
- ``layoutlmv3``     the dense LayoutLMv3 classifier: an ``EEModel`` with no
                     exits, the JAX package's ``{"backbone": ...}`` tree
- ``dit`` / ``dit_rvl``  the image-only classifier: an ``EEModel`` with no
                     exits, no text tower and no relative or spatial bias
                     (``forward_image_classification``)
- ``bert``           the text-only classifier: no visual tower and no
                     spatial bias (``forward_text_classification``)
- ``layoutlmv2``     the genuine LayoutLMv2 (``models/layoutlmv2``): a
                     ``(LayoutLMv2Config, LayoutLMv2Model)`` pair, a dense
                     baseline trained with ``sequence_classification_loss``
- ``pix2struct``     ``NotImplementedError`` (parity: EE/configs.py:508)

When a HuggingFace LayoutLMv3 (for v2: LayoutLMv2) checkpoint is in the
local cache, ``model_weights`` is converted into the model (``convert.
convert_torch_state_dict``, ``layoutlmv2.convert.convert_v2_torch_state_dict``);
otherwise the parameters are random, drawn from the caller's generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.device import resolve_device
from multi_modal_early_exit_tpu_torch.models.layoutlmv3.config import (
    EEModelConfig,
    LayoutLMv3Config,
)

MODEL_NAMES = (
    "EElayoutlmv3", "LTElayoutlmv3", "layoutlmv3", "dit", "dit_rvl",
    "bert", "layoutlmv2", "pix2struct",
)


def _backbone_config(
    cfg, num_labels: int, image_size: Optional[int], seq_len: Optional[int]
) -> LayoutLMv3Config:
    size = getattr(cfg, "model_size", "base")
    if size == "tiny":
        # widen the vocab to the tokenizer's range: the data layer's
        # HashWordTokenizer emits ids in [0, 50265) regardless of model size
        bb = LayoutLMv3Config.tiny(num_labels=num_labels).replace(
            vocab_size=LayoutLMv3Config.base().vocab_size
        )
    elif size == "base":
        bb = LayoutLMv3Config.base(num_labels=num_labels)
    else:
        raise ValueError(f"unknown model_size {size!r} (want 'base'/'tiny')")
    if image_size and image_size != bb.input_size:
        bb = bb.replace(input_size=image_size)
    if seq_len and seq_len > bb.max_position_embeddings - 2:
        bb = bb.replace(max_position_embeddings=seq_len + 2)
    fold = int(getattr(cfg, "scan_fold", 1) or 1)
    if fold > 1:
        bb = bb.replace(scan_fold=fold)
    return bb


def _maybe_load_pretrained(
    bb: LayoutLMv3Config, weights: str
) -> Optional[Dict[str, np.ndarray]]:
    """A locally cached HF LayoutLMv3 checkpoint as the port's backbone
    state dict (names without the ``backbone.`` prefix, numpy arrays); None
    when transformers is absent or the checkpoint is not cached (random
    init, warned), and None, logged as an error, when the conversion fails."""
    from multi_modal_early_exit_tpu_torch.utils.logging import logger_message

    try:
        from transformers import LayoutLMv3Model
    except ImportError:
        return None  # no transformers: random init
    from multi_modal_early_exit_tpu_torch.models.layoutlmv3.convert import (
        convert_torch_state_dict,
        jax_tree_to_state_dict,
    )

    try:
        hf = LayoutLMv3Model.from_pretrained(weights, local_files_only=True)
    except (OSError, ValueError):
        logger_message(
            f"pretrained weights '{weights}' not in the local cache; "
            "using random initialization",
            type="warning",
        )
        return None
    try:
        return jax_tree_to_state_dict(convert_torch_state_dict(hf.state_dict(), bb, prefix=""))
    except (KeyError, ValueError) as e:
        logger_message(
            f"FAILED converting pretrained weights '{weights}' ({e!r}); "
            "falling back to random initialization — fix the converter!",
            type="error",
        )
        return None


def _maybe_load_pretrained_v2(v2, weights: str) -> Optional[Dict[str, np.ndarray]]:
    """The v2 twin of ``_maybe_load_pretrained``: a locally cached HF
    LayoutLMv2 checkpoint's transformer side as the port's state dict (the
    visual tower keeps its init, see ``layoutlmv2/convert.py``); None when
    transformers is absent or the checkpoint is not cached, and None,
    logged as an error, when the conversion fails."""
    from multi_modal_early_exit_tpu_torch.utils.logging import logger_message

    try:
        from transformers import LayoutLMv2Model
    except ImportError:
        return None
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.convert import (
        convert_v2_torch_state_dict,
        jax_tree_to_state_dict,
    )

    try:
        hf = LayoutLMv2Model.from_pretrained(weights, local_files_only=True)
    except (OSError, ValueError, ImportError):
        return None
    try:
        return jax_tree_to_state_dict(convert_v2_torch_state_dict(hf.state_dict(), v2, prefix=""))
    except (KeyError, ValueError) as e:
        logger_message(f"FAILED converting v2 weights '{weights}' ({e!r}); random init",
                       type="error")
        return None


def _build_layoutlmv2(cfg, num_labels, num_hidden_layers, image_size, seq_len, generator):
    """The genuine LayoutLMv2 (parity: HF LayoutLMv2ForSequenceClassification,
    built through AutoModel in the reference, EE/configs.py:451-462): the
    ``(LayoutLMv2Config, LayoutLMv2Model)`` pair, on ``cfg.device``."""
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.config import LayoutLMv2Config
    from multi_modal_early_exit_tpu_torch.models.layoutlmv2.modeling import init_params
    from multi_modal_early_exit_tpu_torch.utils.logging import logger_message

    size = getattr(cfg, "model_size", "base")
    v2 = (LayoutLMv2Config.tiny if size == "tiny" else LayoutLMv2Config.base)(
        num_labels=num_labels)
    if num_hidden_layers:
        v2 = v2.replace(num_hidden_layers=num_hidden_layers)
    if image_size and image_size != v2.input_size:
        v2 = v2.replace(input_size=image_size)
    if seq_len and seq_len > v2.max_position_embeddings - 2:
        v2 = v2.replace(max_position_embeddings=seq_len + 2)
    # widen the vocab to the data layer's tokenizer range: its
    # HashWordTokenizer emits ids in [0, 50265) whatever the model, and a
    # 30522-row table would make the gather raise (ROADMAP.md C3);
    # pretrained rows take the front, the widened tail keeps its init
    v2 = v2.replace(vocab_size=max(v2.vocab_size, LayoutLMv3Config.base().vocab_size))
    model = init_params(v2, generator, device="cpu")
    weights = getattr(cfg, "model_weights", "") or ""
    if "layoutlmv3" in weights:
        # the experiment default names the v3 checkpoint; v2 loads its own
        # (parity: EE/configs.py:451-462 from_pretrained layoutlmv2-base)
        weights = "microsoft/layoutlmv2-base-uncased"
    if weights and size == "base":
        pre = _maybe_load_pretrained_v2(v2, weights)
        if pre is not None:
            state = model.state_dict()
            emb = pad_embedding_tables(
                {k[len("embeddings."):]: v for k, v in pre.items()
                 if k.startswith("embeddings.")},
                {k[len("embeddings."):]: v for k, v in state.items()
                 if k.startswith("embeddings.")})
            pre = {k: v for k, v in pre.items()
                   if not k.startswith(("classifier.", "embeddings."))}
            pre.update({f"embeddings.{k}": v for k, v in emb.items()})
            state.update({k: torch.as_tensor(np.asarray(v)) for k, v in pre.items()})
            model.load_state_dict(state, strict=True)
        else:
            logger_message(
                "layoutlmv2 baseline trains from RANDOM init (pretrained "
                f"'{weights}' unavailable) — numbers are not comparable "
                "to the reference's from_pretrained baseline",
                type="warning",
            )
    return v2, model.to(resolve_device(getattr(cfg, "device", None) or "cuda"))


def pad_embedding_tables(pre: Dict, init: Dict) -> Dict:
    """Pad pretrained embedding tables up to the (wider) initialized ones.

    When the runtime config widens a table beyond the checkpoint — vocab to
    the hermetic tokenizer range, positions when seq_len pushes
    max_position_embeddings past the checkpoint's — the pretrained rows
    occupy the front and the random-init tail is kept; a short table would
    make the embedding gather read past its rows. Non-2D leaves (LayerNorm)
    and matching shapes pass through. Leaves are numpy arrays or tensors;
    padded ones come back as numpy."""
    out = dict(pre)
    for key_name, arr in pre.items():
        init_arr = init.get(key_name)
        if (
            key_name != "LayerNorm"
            and init_arr is not None
            and np.ndim(arr) == 2
            and np.shape(arr)[0] < np.shape(init_arr)[0]
            and np.shape(arr)[1] == np.shape(init_arr)[1]
        ):
            full = _numpy(init_arr).copy()
            full[: np.shape(arr)[0]] = _numpy(arr)
            out[key_name] = full
    return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def infer_backbone_config(
    state: Dict, base: Optional[LayoutLMv3Config] = None
) -> LayoutLMv3Config:
    """The backbone config of a state dict (the port's names, with or
    without the ``backbone.`` prefix), read off its shapes.

    Every shape-bearing field (vocab, hidden, layers, heads, intermediate,
    coordinate/shape sizes, positions, patch/input size, bias bins, labels)
    is read off the tensors; the other hyperparameters (dropouts, eps,
    max_rel distances) come from ``base`` (defaults: base()). Used by
    ``serving.Pipeline.from_checkpoint``, so that a restored model always
    matches its weights whatever the saved config recorded."""
    base = base or LayoutLMv3Config.base()
    prefix = "backbone." if any(k.startswith("backbone.") for k in state) else ""
    bb = {k[len(prefix):]: np.shape(v) for k, v in state.items() if k.startswith(prefix)}
    layers = sorted({int(k.split(".")[2]) for k in bb if k.startswith("encoder.layers.")})
    inter = bb["encoder.layers.0.intermediate.weight"]  # (intermediate, hidden)
    hidden = int(inter[1])
    kwargs = dict(
        hidden_size=hidden,
        num_hidden_layers=len(layers),
        intermediate_size=int(inter[0]),
        has_relative_attention_bias="encoder.rel_pos_bias" in bb,
        has_spatial_attention_bias="encoder.rel_pos_x_bias" in bb,
    )
    if "embeddings.word_embeddings" in bb:  # the text tower
        kwargs.update(
            vocab_size=int(bb["embeddings.word_embeddings"][0]),
            max_position_embeddings=int(bb["embeddings.position_embeddings"][0]),
            max_2d_position_embeddings=int(bb["embeddings.x_position_embeddings"][0]),
            coordinate_size=int(bb["embeddings.x_position_embeddings"][1]),
            shape_size=int(bb["embeddings.h_position_embeddings"][1]),
        )
    if "visual.patch_embed.weight" in bb:  # the vision tower
        patch_size = int(round((bb["visual.patch_embed.weight"][1] / 3) ** 0.5))
        n_patches = int(bb["visual.pos_embed"][1]) - 1
        kwargs.update(patch_size=patch_size,
                      input_size=int(round(n_patches ** 0.5)) * patch_size)
    if "classifier.out_proj.bias" in bb:
        kwargs["num_labels"] = int(bb["classifier.out_proj.bias"][0])
    if "encoder.rel_pos_bias" in bb:
        kwargs["rel_pos_bins"] = int(bb["encoder.rel_pos_bias"][0])
        kwargs["num_attention_heads"] = int(bb["encoder.rel_pos_bias"][1])
    else:
        # heads not shape-inferable without bias tables; keep base ratio
        kwargs["num_attention_heads"] = max(hidden // base.head_dim, 1)
    if "encoder.rel_pos_x_bias" in bb:
        kwargs["rel_2d_pos_bins"] = int(bb["encoder.rel_pos_x_bias"][0])
    return base.replace(**kwargs)


def build_model(
    cfg,
    num_labels: int = 16,
    num_hidden_layers: Optional[int] = None,
    image_size: Optional[int] = None,
    seq_len: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
):
    """``(EEModelConfig, EEModel)`` from an ExperimentConfig-like object
    (for ``layoutlmv2``: ``(LayoutLMv2Config, LayoutLMv2Model)``), the
    model random from ``generator`` (a CPU generator seeded with
    ``cfg.seed`` if none) or converted from a cached pretrained checkpoint,
    on ``cfg.device`` (``cuda`` by default)."""
    from multi_modal_early_exit_tpu_torch.models.ee.model import init_ee_params

    name = cfg.model
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; available: {MODEL_NAMES}")
    if name == "pix2struct":
        raise NotImplementedError(
            "pix2struct is not implemented (parity: EE/configs.py:508)"
        )

    generator = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    if name == "layoutlmv2":
        return _build_layoutlmv2(cfg, num_labels, num_hidden_layers, image_size, seq_len,
                                 generator)
    bb = _backbone_config(cfg, num_labels, image_size, seq_len)
    if num_hidden_layers:
        bb = bb.replace(num_hidden_layers=num_hidden_layers)
    if name in ("dit", "dit_rvl"):
        # image-only: no text tower, and no 1D/2D relative bias, as a ViT
        bb = bb.replace(has_relative_attention_bias=False, has_spatial_attention_bias=False)
    if name == "bert":
        bb = bb.replace(has_spatial_attention_bias=False)

    exit_cfg = cfg.exit_config() if hasattr(cfg, "exit_config") else ExitConfig()
    if name == "LTElayoutlmv3":
        exit_cfg = ExitConfig(**{**exit_cfg.to_dict(), "use_lte": True})
    if name in ("layoutlmv3", "dit", "dit_rvl", "bert"):
        # dense: the backbone alone, no exits; the single-modality variants
        # allocate only the tower they use (EE/configs.py:429-449, 482-493)
        exit_cfg = ExitConfig(exits=())
    model_cfg = EEModelConfig(backbone=bb, exit=exit_cfg)
    model = init_ee_params(model_cfg, generator, device="cpu",
                           with_text=name not in ("dit", "dit_rvl"), with_vision=name != "bert")

    weights = getattr(cfg, "model_weights", "") or ""
    if weights and bb.input_size == 224 and getattr(cfg, "model_size", "base") == "base":
        pretrained = _maybe_load_pretrained(bb, weights)
        if pretrained is not None:
            # the classifier keeps its random init: the label count differs
            # per dataset; a pruned variant takes only its own towers
            backbone = model.backbone.state_dict()
            pretrained = pad_embedding_tables(
                {k: v for k, v in pretrained.items()
                 if not k.startswith("classifier.") and k in backbone},
                backbone)
            backbone.update({k: torch.as_tensor(np.asarray(v)) for k, v in pretrained.items()})
            model.backbone.load_state_dict(backbone, strict=True)
    return model_cfg, model.to(resolve_device(getattr(cfg, "device", None) or "cuda"))
