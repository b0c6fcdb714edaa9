"""Operations and bytes from shapes alone, and the card's peaks.

The model's FLOPs are those of the published model at its own sequence
length (512 text + 197 visual tokens for LayoutLMv3-base), not the port's
padded width: a matrix product of (m, k) by (k, n) is 2 m k n operations.
A kernel's bound is the larger of its bytes over the memory rate and its
operations over the tensor-core rate, each input byte read once and each
output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def seq_len(cfg: dict) -> int:
    """Text positions plus the visual tokens (patches and [CLS])."""
    side = cfg["input_size"] // cfg["patch_size"]
    return cfg["text_len"] + side * side + 1


def layer_flops(cfg: dict, s: int) -> float:
    """One encoder layer at s tokens: q, k, v and output projections,
    the two MLP products, and the two attention products."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    return 8.0 * s * h * h + 4.0 * s * h * f + 4.0 * s * s * h


def head_flops(cfg: dict) -> float:
    """One exit head or the classifier: dense (h x h) when the head has two
    layers, then the projection to the labels."""
    h, k = cfg["hidden_size"], cfg["num_labels"]
    dense = 2.0 * h * h if cfg.get("exit_head_num_layers", 2) == 2 else 0.0
    return dense + 2.0 * h * k


def embed_flops(cfg: dict) -> float:
    """The patch embedding (the text embedding is lookups and sums)."""
    side = cfg["input_size"] // cfg["patch_size"]
    patch = cfg["num_channels"] * cfg["patch_size"] ** 2
    return 2.0 * side * side * patch * cfg["hidden_size"]


def encoder_exit_layers(cfg: dict) -> list:
    return [e for e in cfg["exits"] if isinstance(e, int)]


def exit_order(cfg: dict) -> list:
    """Exits in the model's canonical order: vision, text, concat, then the
    encoder exits ascending; the final classifier is index len(order)."""
    emb = [e for e in ("vision_avg", "text_avg", "text_visual_concat") if e in cfg["exits"]]
    return emb + sorted(encoder_exit_layers(cfg))


def doc_flops_to_exit(cfg: dict, exit_index: int) -> float:
    """Forward FLOPs of one document that left at ``exit_index`` (canonical
    order; len(order) is the final classifier), with every exit head it
    evaluated on the way."""
    order = exit_order(cfg)
    s = seq_len(cfg)
    total = embed_flops(cfg)
    layers = 0
    for j, e in enumerate(order[:exit_index + 1]):
        if isinstance(e, int):
            layers = e
        total += head_flops(cfg)
    if exit_index >= len(order):
        layers = cfg["num_hidden_layers"]
        total += head_flops(cfg)  # the classifier
    return total + layers * layer_flops(cfg, s)


def train_doc_flops(cfg: dict) -> float:
    """3x the full-depth forward with every exit head and the classifier,
    per document (recomputation not counted)."""
    fwd = (embed_flops(cfg) + cfg["num_hidden_layers"] * layer_flops(cfg, seq_len(cfg))
           + (len(exit_order(cfg)) + 1) * head_flops(cfg))
    return 3.0 * fwd


def padded(s: int, multiple: int = 128) -> int:
    return -(-s // multiple) * multiple


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS)


def attn_fwd_cost(b: int, heads: int, s: int, d: int, esize: int = 2):
    """(bytes, operations) of one packed attention forward (#2) at s
    tokens: q, k, v read and the output written, each (b, s, heads*d); the
    (b, heads, s, s) block of the bias read; 4 b heads s^2 d operations."""
    qkv = b * s * heads * d * esize
    block = b * heads * s * s * esize
    return 4 * qkv + block, 4.0 * b * heads * s * s * d


def attn_bwd_cost(b: int, heads: int, s: int, d: int, esize: int = 2):
    """(bytes, operations) of one training backward pair (#8, the bias not
    chained): q, k, v, o and do read, dq, dk, dv written; the bias block
    read, the (b, heads, P, P) bias cotangent written, the f32 lse read;
    10 b heads s^2 d operations."""
    p = padded(s)
    qkv = b * s * heads * d * esize
    block = b * heads * s * s * esize
    plane = b * heads * p * p * esize
    lse = b * heads * p * 4
    return 8 * qkv + block + plane + lse, 10.0 * b * heads * s * s * d


def tower_flops(cfg: dict) -> float:
    """LayoutLMv2's ResNeXt-FPN tower on one page: the stem, every
    bottleneck's three convolutions (the 3x3 grouped) and its shortcut, the
    FPN's lateral 1x1 convolutions and the p2 3x3 output (nearest
    upsampling and pooling count nothing)."""
    side = cfg["input_size"] // 2            # the 7x7/2 stem
    stem, groups = cfg["backbone_stem_channels"], cfg["backbone_groups"]
    fpn = cfg["fpn_channels"]
    total = 2.0 * side * side * stem * 3 * 49
    side //= 2                               # the 3x3/2 max pool
    c_in = stem
    for s, depth in enumerate(cfg["backbone_depths"]):
        c_mid = groups * cfg["backbone_width_per_group"] * 2 ** s
        c_out = stem * 4 * 2 ** s
        for i in range(depth):
            out_side = side // 2 if (i == 0 and s > 0) else side
            total += 2.0 * side * side * c_mid * c_in                       # conv1
            total += 2.0 * out_side ** 2 * c_mid * (c_mid // groups) * 9    # grouped 3x3
            total += 2.0 * out_side ** 2 * c_out * c_mid                    # conv3
            if i == 0:
                total += 2.0 * out_side ** 2 * c_out * c_in                 # shortcut
            side, c_in = out_side, c_out
        total += 2.0 * side * side * fpn * c_out                            # lateral
        if s == 0:
            p2_side = side
    return total + 2.0 * p2_side ** 2 * fpn * fpn * 9                        # p2 output


def v2_seq_len(cfg: dict) -> int:
    ph, pw, _ = cfg["image_feature_pool_shape"]
    return cfg["text_len"] + ph * pw


def v2_doc_flops(cfg: dict) -> float:
    """Forward FLOPs of LayoutLMv2 on one document at 512 + 49 tokens:
    the tower, the projection of the pooled grid, the encoder and the
    classifier on 3 x hidden."""
    ph, pw, c = cfg["image_feature_pool_shape"]
    h = cfg["hidden_size"]
    return (tower_flops(cfg) + 2.0 * ph * pw * c * h
            + cfg["num_hidden_layers"] * layer_flops(cfg, v2_seq_len(cfg))
            + 2.0 * 3 * h * cfg["num_labels"])
