"""Early-exit vocabulary: strategies, inference criteria, head types, ExitConfig.

The PyTorch port's own copy of the JAX package's ``config/exit_config.py``;
``EarlyExitInference.get_function`` returns the port's criteria
(``multi_modal_early_exit_tpu_torch.ops.criteria``).

Capability parity with the reference enums and config object
(reference: EE/models/EE_modules.py:46-194), re-typed as Python dataclass/enum
with validation.  Unlike the reference (which stores exits as a mixed
str/int list parsed ad hoc, EE/models/LayoutLMv3.py:100-108), exits are parsed
once into a canonical tuple and validated against the model depth.
"""

from __future__ import annotations

import dataclasses
import operator
from enum import Enum
from typing import Callable, ClassVar, List, Sequence, Tuple, Union


class StrChoice(str, Enum):
    """String-valued enum used for config vocabulary fields.

    Serializes to its raw string value (so configs round-trip through JSON)
    and rejects unknown values with the accepted vocabulary in the message.
    Capability parity with the reference's enum base (EE/models/EE_modules.py:50-68),
    written in this framework's own idiom.
    """

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value

    @classmethod
    def _missing_(cls, value):
        choices = ", ".join(repr(c.value) for c in cls)
        raise ValueError(f"unknown {cls.__name__} {value!r}; expected one of: {choices}")


class EarlyExitStrategy(StrChoice):
    """Training strategies (reference: EE/models/EE_modules.py:71-113).

    Paper lineage: PABEE, DeeBERT, BERTxit, MultiExitViT, RomeBERT, FrameExit.
    """

    JOINT = "joint"
    JOINT_W_AVG = "joint_weighted_avg"
    JOINT_W = "joint_weighted"
    TWO_STAGE = "two-stage"
    ALTERNATING = "alternating"
    LAYERWISE = "layerwise"
    ONE_STAGE_SUBGRAPHS = "one_stage_subgraphs"
    ONE_STAGE_SUBGRAPHS_WEIGHTED = "one_stage_subgraphs_weighted"
    ONE_STAGE_SUBGRAPHS_ENTROPYREG = "one_stage_subgraphs_entropyreg"
    ONE_STAGE_SUBGRAPHS_WEIGHTED_ENTROPYREG = "one_stage_subgraphs_weighted_entropyreg"
    TWO_STAGE_SUBGRAPHS = "two_stage_subgraphs"
    TWO_STAGE_SUBGRAPHS_WEIGHTED = "two_stage_subgraphs_weighted"
    TWO_STAGE_SUBGRAPHS_ENTROPYREG = "two_stage_subgraphs_entropyreg"
    TWO_STAGE_SUBGRAPHS_WEIGHTED_ENTROPYREG = "two_stage_subgraphs_weighted_entropyreg"

    @property
    def is_one_stage(self) -> bool:
        return "one_stage" in self.value

    @property
    def is_two_stage(self) -> bool:
        return "two_stage" in self.value or self.value == "two-stage"

    @property
    def is_weighted(self) -> bool:
        return "weighted" in self.value and "avg" not in self.value

    @property
    def uses_entropyreg(self) -> bool:
        return "entropyreg" in self.value


class EarlyExitInference(StrChoice):
    """Exit criteria (reference: EE/models/EE_modules.py:116-146)."""

    MAX_CONFIDENCE = "max_confidence"  # exit when max softmax prob > threshold
    ENTROPY = "entropy"  # exit when predictive entropy < threshold
    PATIENCE = "patience"  # exit when prediction unchanged for t exits (PABEE)
    LTE = "lte"  # learning-to-exit regressor score < per-exit threshold

    @property
    def is_stateful(self) -> bool:
        """Patience is stateful across exits: its criterion function takes
        the whole (E, B, K) prediction-logit store, not one exit's logits."""
        return self == EarlyExitInference.PATIENCE

    def get_function(self) -> Callable:
        from multi_modal_early_exit_tpu_torch.ops import criteria

        if self == EarlyExitInference.MAX_CONFIDENCE:
            return criteria.max_confidence
        if self == EarlyExitInference.ENTROPY:
            return criteria.entropy
        if self == EarlyExitInference.LTE:
            return criteria.lte
        if self == EarlyExitInference.PATIENCE:
            return criteria.patience_counts
        raise NotImplementedError(f"{self} not implemented")

    def get_sign(self) -> Callable:
        """Comparison against the threshold: True means 'exit now'."""
        if self == EarlyExitInference.MAX_CONFIDENCE:
            return operator.gt  # higher is better
        if self in (EarlyExitInference.ENTROPY, EarlyExitInference.LTE):
            return operator.lt  # lower is better
        if self == EarlyExitInference.PATIENCE:
            return operator.ge  # count of consecutive agreements reaches t
        raise NotImplementedError(f"{self} not implemented")


class EarlyExitHead(StrChoice):
    """Exit head types (reference: EE/models/EE_modules.py:168-172)."""

    GATE = "gate"  # binary head: 2 logits, final classifier re-used on exit input
    RAMP = "ramp"  # per-exit classifier: num_labels logits
    EMBEXIT = "embexit"  # embedding-level classifier (treated as ramp)


EMBEDDING_EXITS: Tuple[str, ...] = ("vision_avg", "text_avg", "text_visual_concat")

ExitSpec = Union[str, int]


def parse_exits(
    exits: Union[str, Sequence[ExitSpec]], num_hidden_layers: int = 12
) -> Tuple[ExitSpec, ...]:
    """Parse an exits specification into a canonical tuple.

    Accepts a comma-separated string like ``"text_avg,vision_avg,7"`` (the CLI
    form, reference: EE/models/LayoutLMv3.py:100-108) or a sequence of
    str/int. Encoder exits are 1-based layer indices.
    """
    if isinstance(exits, str):
        items: List[ExitSpec] = [e.strip() for e in exits.split(",") if e.strip()]
    else:
        items = list(exits)
    parsed: List[ExitSpec] = []
    for item in items:
        if isinstance(item, str):
            try:
                item = int(item)
            except ValueError:
                pass
        if isinstance(item, int):
            if not 1 <= item <= num_hidden_layers:
                raise ValueError(
                    f"encoder exit {item} out of range 1..{num_hidden_layers}"
                )
            parsed.append(item)
        else:
            if item not in EMBEDDING_EXITS:
                raise ValueError(
                    f"unknown embedding exit {item!r}; valid: {EMBEDDING_EXITS}"
                )
            parsed.append(item)
    encoder = [e for e in parsed if isinstance(e, int)]
    if encoder != sorted(encoder):
        raise ValueError(f"encoder exits must be ascending, got {encoder}")
    if len(set(parsed)) != len(parsed):
        raise ValueError(f"duplicate exits in {parsed}")
    return tuple(parsed)


@dataclasses.dataclass
class ExitConfig:
    """Typed early-exit configuration (reference: EE/models/EE_modules.py:175-194).

    Defaults match the reference's ExitConfig defaults.
    """

    training_strategy: EarlyExitStrategy = EarlyExitStrategy.JOINT_W_AVG
    inference_strategy: EarlyExitInference = EarlyExitInference.MAX_CONFIDENCE
    global_threshold: float = 0.9
    exits: Tuple[ExitSpec, ...] = ("text_avg", "vision_avg", 1, 4, 8)
    encoder_layer_strategy: EarlyExitHead = EarlyExitHead.RAMP
    exit_head_num_layers: int = 2
    use_lte: bool = False
    gamma: float = 0.0
    alpha: float = 0.5
    temperature: float = 1.0
    # the deepest layer an encoder exit may follow (LayoutLMv3-base's 12; a
    # deeper backbone's subclass raises it)
    max_exit_layer: ClassVar[int] = 12

    def __post_init__(self):
        self.training_strategy = EarlyExitStrategy(self.training_strategy)
        self.inference_strategy = EarlyExitInference(self.inference_strategy)
        self.encoder_layer_strategy = EarlyExitHead(self.encoder_layer_strategy)
        self.exits = parse_exits(self.exits, self.max_exit_layer)
        if self.exit_head_num_layers not in (1, 2):
            raise ValueError("exit_head_num_layers must be 1 or 2")

    # --- derived views -------------------------------------------------
    @property
    def embedding_exits(self) -> Tuple[str, ...]:
        return tuple(e for e in self.exits if isinstance(e, str))

    @property
    def encoder_exits(self) -> Tuple[int, ...]:
        return tuple(e for e in self.exits if isinstance(e, int))

    @property
    def num_exits(self) -> int:
        return len(self.exits)

    @property
    def apply_gating(self) -> bool:
        return self.encoder_layer_strategy == EarlyExitHead.GATE

    @classmethod
    def from_dict(cls, d: dict) -> "ExitConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["training_strategy"] = str(self.training_strategy)
        d["inference_strategy"] = str(self.inference_strategy)
        d["encoder_layer_strategy"] = str(self.encoder_layer_strategy)
        d["exits"] = list(self.exits)
        return d
