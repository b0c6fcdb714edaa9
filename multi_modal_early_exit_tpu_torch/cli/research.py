"""Offline threshold-mixture research CLI (parity: EE/thresh.py __main__ and
EE/large_scale.py __main__).

    python -m multi_modal_early_exit_tpu_torch.cli.research \
        --checkpoint-dir results/<ckpt>-<ds> --num-mixtures 1000000 \
        --backend native

Loads a dumped logit store (written by either package's ``cli.evaluate``),
generates per-exit percentile threshold grids and random mixtures,
evaluates (accuracy, average_exit) for every mixture with the chosen backend
(``torch`` on the card, ``native`` C++/OpenMP, ``numpy``; ``auto`` is
native), and saves the Pareto frontier + full results. The port's copy of
the JAX package's ``cli/research.py``, without its XLA backend.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from multi_modal_early_exit_tpu_torch.evaluation.thresholds import (
    assign_exits_2d,
    csf_matrix,
    mixture_pareto_sweep,
)
from multi_modal_early_exit_tpu_torch.utils.artifacts import load_npz, save_json
from multi_modal_early_exit_tpu_torch.utils.logging import logger_message


def _efficiency_analysis(checkpoint_dir: str, num_labels: int):
    """Rebuild an ``Analysis`` from the dump dir's ``config.json`` (parity:
    EE/large_scale.py:87-128 builds the model to emit a full efficiency log
    per mixture). A random init on the CPU suffices — only parameter counts
    and analytic FLOPs are read. Returns None (log disabled, warned) when the
    dump carries no usable config."""
    cfg_path = os.path.join(checkpoint_dir, "config.json")
    if not os.path.exists(cfg_path):
        logger_message(
            "no config.json in dump dir — per-mixture efficiency log "
            "disabled", type="warning",
        )
        return None
    try:
        from multi_modal_early_exit_tpu_torch.config.experiment import (
            ExperimentConfig,
        )
        from multi_modal_early_exit_tpu_torch.evaluation.analysis import Analysis
        from multi_modal_early_exit_tpu_torch.models.registry import build_model
        from multi_modal_early_exit_tpu_torch.utils.artifacts import load_json

        exp = ExperimentConfig.from_dict(load_json(cfg_path))
        model_cfg, model = build_model(exp.replace(device="cpu", model_weights=""),
                                       num_labels=num_labels)
        return Analysis(model, model_cfg)
    except Exception as e:  # efficiency log must never fail the search
        logger_message(f"efficiency log disabled ({e})", type="warning")
        return None


def pareto_front(accuracy: np.ndarray, average_exit: np.ndarray) -> np.ndarray:
    """Indices of the Pareto-optimal mixtures (max accuracy, min avg exit)."""
    order = np.lexsort((-accuracy, average_exit))
    best = -np.inf
    keep = []
    for i in order:
        if accuracy[i] > best:
            best = accuracy[i]
            keep.append(int(i))
    return np.asarray(keep)


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="threshold mixture research")
    parser.add_argument("--checkpoint-dir", required=True,
                        help="results dir with exit_logits-test.npz")
    parser.add_argument("--num-mixtures", type=int, default=1_000_000)
    parser.add_argument("--num-per-exit", type=int, default=10)
    parser.add_argument("--csf", default="msp",
                        choices=["msp", "entropy", "margin"])
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "native", "torch", "numpy"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--plot", action="store_true",
                        help="save an accuracy-vs-average-exit Pareto scatter")
    parser.add_argument("--time-sweeps", action="store_true",
                        help="wall-clock naive/opt0/opt1 global sweeps and "
                        "record sweep_timings.json (the reference's "
                        "__main__ harness, EE/thresh.py:313-315)")
    args = parser.parse_args(argv)

    logits = load_npz(os.path.join(args.checkpoint_dir, "exit_logits-test.npz"))
    references = load_npz(
        os.path.join(args.checkpoint_dir, "references-test.npz")
    )

    if args.time_sweeps:
        from multi_modal_early_exit_tpu_torch.evaluation.thresholds import (
            time_global_sweeps,
        )

        # the reference's comparison grid (thresh.py:312): 100 thresholds;
        # skip the O(T*N*E) python naive above 2k samples to keep it sane
        grid = np.linspace(0.1, 0.2, 100)
        timings = time_global_sweeps(
            logits, grid, args.csf, include_naive=logits.shape[1] <= 2000
        )
        save_json(
            os.path.join(args.checkpoint_dir, "sweep_timings.json"),
            {"csf": args.csf, "n_thresholds": len(grid),
             "store_shape": list(logits.shape), "seconds": timings},
        )
        logger_message(f"sweep timings: {timings}")

    t0 = time.perf_counter()
    result = mixture_pareto_sweep(
        logits, references,
        num_mixtures=args.num_mixtures, num_per_exit=args.num_per_exit,
        csf=args.csf, seed=args.seed, backend=args.backend,
    )
    dt = time.perf_counter() - t0
    logger_message(
        f"{args.num_mixtures} mixtures in {dt:.1f}s "
        f"({args.num_mixtures / dt:.0f}/s, backend={args.backend})"
    )

    front = pareto_front(result["accuracy"], result["average_exit"])

    # per-mixture efficiency log for the Pareto FRONT (the reference emits
    # it per mixture, EE/large_scale.py:87-128 — front-only keeps the 1M+
    # search fast while every reported point carries the full log)
    analysis = _efficiency_analysis(args.checkpoint_dir, logits.shape[-1])
    scores = csf_matrix(logits, args.csf) if analysis is not None else None

    def efficiency_of(i):
        if analysis is None:
            return None
        from multi_modal_early_exit_tpu_torch.evaluation.analysis import calc_flops
        from multi_modal_early_exit_tpu_torch.evaluation.policy import (
            exit_distribution_of,
        )

        exits = assign_exits_2d(
            scores, result["thresholds"][i][None]
        )[0]
        dist = exit_distribution_of(exits, logits.shape[0])
        return calc_flops(dist, analysis, {})

    out = {
        "num_mixtures": args.num_mixtures,
        "csf": args.csf,
        "seconds": dt,
        "pareto": [
            {
                "accuracy": float(result["accuracy"][i]),
                "average_exit": float(result["average_exit"][i]),
                "thresholds": result["thresholds"][i].tolist(),
                "efficiency": efficiency_of(i),
            }
            for i in front
        ],
    }
    save_json(os.path.join(args.checkpoint_dir, "mixture_search.json"), out)

    if args.plot:
        # accuracy-vs-average-exit scatter with the Pareto front highlighted
        # (parity: the plotly scatter in EE/thresh.py:288-302)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(7, 5))
            n_bg = min(len(result["accuracy"]), 20000)
            idx_bg = np.random.default_rng(0).choice(
                len(result["accuracy"]), n_bg, replace=False
            )
            ax.scatter(result["average_exit"][idx_bg],
                       result["accuracy"][idx_bg],
                       s=2, alpha=0.15, label="mixtures")
            ax.plot(result["average_exit"][front],
                    result["accuracy"][front],
                    "o-", color="crimson", ms=4, label="Pareto front")
            ax.set_xlabel("average exit index")
            ax.set_ylabel("accuracy")
            ax.legend()
            path = os.path.join(args.checkpoint_dir, "pareto.png")
            fig.savefig(path, dpi=120, bbox_inches="tight")
            logger_message(f"Pareto scatter saved to {path}")
        except Exception as e:  # plotting never fails the search
            logger_message(f"plotting skipped: {e}", type="warning")
    return out


if __name__ == "__main__":
    main()
