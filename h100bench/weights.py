"""Random weights from the seed, made on the device in one large draw.

The names are the keys of the port's ``EEModel.state_dict()``, so the same
tensors can be loaded into the program and read by the plain reference.
Matrices, convolutions, tables and embeddings are normal(0,
initializer_range); biases are 0, LayerNorm and frozen-BN scales 1, and
LayoutLMv2's pixel mean and std detectron2's constants.
"""

from __future__ import annotations

import torch


def ee_layout(cfg: dict) -> list:
    """[(name, shape, kind)] of EE LayoutLMv3, kind 'w' (normal), 'b' (0)
    or 'one' (1)."""
    h, f, k = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_labels"]
    heads = cfg["num_attention_heads"]
    out = []

    def lin(name, d_in, d_out):
        out.extend([(f"{name}.weight", (d_out, d_in), "w"), (f"{name}.bias", (d_out,), "b")])

    def ln(name, d):
        out.extend([(f"{name}.weight", (d,), "one"), (f"{name}.bias", (d,), "b")])

    e = "backbone.embeddings"
    out += [(f"{e}.word_embeddings", (cfg["vocab_size"], h), "w"),
            (f"{e}.position_embeddings", (cfg["max_position_embeddings"], h), "w"),
            (f"{e}.token_type_embeddings", (cfg["type_vocab_size"], h), "w")]
    n2d = cfg["max_2d_position_embeddings"]
    for axis, width in (("x", "coordinate_size"), ("y", "coordinate_size"),
                        ("h", "shape_size"), ("w", "shape_size")):
        out.append((f"{e}.{axis}_position_embeddings", (n2d, cfg[width]), "w"))
    ln(f"{e}.LayerNorm", h)
    v = "backbone.visual"
    side = cfg["input_size"] // cfg["patch_size"]
    lin(f"{v}.patch_embed", cfg["num_channels"] * cfg["patch_size"] ** 2, h)
    out += [(f"{v}.cls_token", (1, 1, h), "w"), (f"{v}.pos_embed", (1, side * side + 1, h), "w")]
    ln(f"{v}.norm", h)
    ln("backbone.LayerNorm", h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"backbone.encoder.layers.{i}"
        for name in ("query", "key", "value", "output"):
            lin(f"{p}.attention.{name}", h, h)
        ln(f"{p}.attention.output_LayerNorm", h)
        lin(f"{p}.intermediate", h, f)
        lin(f"{p}.output", f, h)
        ln(f"{p}.output_LayerNorm", h)
    out += [("backbone.encoder.rel_pos_bias", (cfg["rel_pos_bins"], heads), "w"),
            ("backbone.encoder.rel_pos_x_bias", (cfg["rel_2d_pos_bins"], heads), "w"),
            ("backbone.encoder.rel_pos_y_bias", (cfg["rel_2d_pos_bins"], heads), "w")]

    def head(name):
        if cfg["exit_head_num_layers"] == 2:
            lin(f"{name}.dense", h, h)
        lin(f"{name}.out_proj", h, k)

    lin("backbone.classifier.dense", h, h)
    lin("backbone.classifier.out_proj", h, k)
    for name in ("vision_avg", "text_avg", "text_visual_concat"):
        if name in cfg["exits"]:
            head(f"embedding_exits.{name}")
    for j, _ in enumerate(x for x in cfg["exits"] if isinstance(x, int)):
        head(f"encoder_exits.{j}")
    return out


# detectron2's pixel mean and std (BGR), LayoutLMv2's input normalisation
PIXEL_MEAN = (103.53, 116.28, 123.675)
PIXEL_STD = (57.375, 57.12, 58.395)


def v2_layout(cfg: dict) -> list:
    """[(name, shape, kind)] of LayoutLMv2 with its ResNeXt-FPN tower."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    out = []

    def lin(name, d_in, d_out):
        out.extend([(f"{name}.weight", (d_out, d_in), "w"), (f"{name}.bias", (d_out,), "b")])

    def ln(name, d):
        out.extend([(f"{name}.weight", (d,), "one"), (f"{name}.bias", (d,), "b")])

    e = "embeddings"
    n2d = cfg["max_2d_position_embeddings"]
    out += [(f"{e}.word_embeddings", (cfg["vocab_size"], h), "w"),
            (f"{e}.position_embeddings", (cfg["max_position_embeddings"], h), "w"),
            (f"{e}.token_type_embeddings", (cfg["type_vocab_size"], h), "w")]
    for axis, width in (("x", "coordinate_size"), ("y", "coordinate_size"),
                        ("h", "shape_size"), ("w", "shape_size")):
        out.append((f"{e}.{axis}_position_embeddings", (n2d, cfg[width]), "w"))
    ln(f"{e}.LayerNorm", h)
    t = "visual_backbone"
    stem = cfg["backbone_stem_channels"]
    out += [(f"{t}.stem_conv", (stem, 3, 7, 7), "w"), (f"{t}.pixel_mean", (1, 3, 1, 1), "mean"),
            (f"{t}.pixel_std", (1, 3, 1, 1), "std")]
    ln(f"{t}.stem_bn", stem)
    c_in, groups = stem, cfg["backbone_groups"]
    for s, depth in enumerate(cfg["backbone_depths"]):
        c_mid = groups * cfg["backbone_width_per_group"] * 2 ** s
        c_out = stem * 4 * 2 ** s
        for i in range(depth):
            p = f"{t}.stages.{s}.{i}"
            out += [(f"{p}.conv1", (c_mid, c_in, 1, 1), "w"),
                    (f"{p}.conv2", (c_mid, c_mid // groups, 3, 3), "w"),
                    (f"{p}.conv3", (c_out, c_mid, 1, 1), "w")]
            if i == 0:  # the first block changes the width (and, past stage 0, the stride)
                out.append((f"{p}.shortcut", (c_out, c_in, 1, 1), "w"))
            for bn, c in (("bn1", c_mid), ("bn2", c_mid), ("bn3", c_out)):
                ln(f"{p}.{bn}", c)
            if i == 0:
                ln(f"{p}.shortcut_bn", c_out)
            c_in = c_out
        fpn = cfg["fpn_channels"]
        out += [(f"{t}.fpn_lateral.{s}.conv", (fpn, c_out, 1, 1), "w"),
                (f"{t}.fpn_lateral.{s}.bias", (fpn,), "b")]
    out += [(f"{t}.fpn_output_p2.conv", (fpn, fpn, 3, 3), "w"), (f"{t}.fpn_output_p2.bias", (fpn,), "b")]
    lin("visual_proj", cfg["image_feature_pool_shape"][2], h)
    ln("visual_LayerNorm", h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("query", "key", "value", "output"):
            lin(f"{p}.attention.{name}", h, h)
        ln(f"{p}.attention.output_LayerNorm", h)
        lin(f"{p}.intermediate", h, f)
        lin(f"{p}.output", f, h)
        ln(f"{p}.output_LayerNorm", h)
    out += [("encoder.rel_pos_bias", (cfg["rel_pos_bins"], heads), "w"),
            ("encoder.rel_pos_x_bias", (cfg["rel_2d_pos_bins"], heads), "w"),
            ("encoder.rel_pos_y_bias", (cfg["rel_2d_pos_bins"], heads), "w")]
    lin("classifier", 3 * h, cfg["num_labels"])
    return out


LAYOUTS = {"ee_layoutlmv3": ee_layout, "layoutlmv2": v2_layout}


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} on ``device`` in ``dtype``: one normal draw from a
    generator on the device, split into views, biases and scales filled."""
    layout = LAYOUTS[cfg["model"]](cfg)
    sizes = [torch.Size(s).numel() for _, s, _ in layout]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(cfg["initializer_range"])
    flat = flat.to(dtype)
    out, at = {}, 0
    for (name, shape, kind), n in zip(layout, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "b":
            t.zero_()
        elif kind == "one":
            t.fill_(1.0)
        elif kind in ("mean", "std"):
            t.copy_(torch.tensor(PIXEL_MEAN if kind == "mean" else PIXEL_STD).view(shape))
        out[name] = t
    return out


def head_names(cfg: dict) -> list:
    """The output projections of every exit head, canonical order, then the
    classifier's."""
    names = [f"embedding_exits.{e}.out_proj"
             for e in ("vision_avg", "text_avg", "text_visual_concat") if e in cfg["exits"]]
    names += [f"encoder_exits.{j}.out_proj"
              for j, _ in enumerate(x for x in cfg["exits"] if isinstance(x, int))]
    return names + ["backbone.classifier.out_proj"]
