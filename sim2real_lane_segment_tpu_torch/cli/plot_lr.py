"""Learning-rate schedule plot, the reference ``utils/plotLR.py``.

Counterpart of the JAX package's ``cli/plot_lr.py``: the cosine-annealing
schedules the training regimes use (AdamW's rate, and the two rates of
MME's SGD phase) over ``--epochs`` epochs, plotted to a PNG:

    python -m sim2real_lane_segment_tpu_torch.cli.plot_lr --out lr.png

``schedules`` computes the three series from ``train/schedules.
cosine_annealing``; ``main`` plots them with matplotlib (Agg, headless),
imported inside ``main`` as the JAX CLI does.  The card's machine has no
matplotlib, so there only ``schedules`` runs.
"""
from __future__ import annotations

import argparse

from ..train.schedules import cosine_annealing

T_MAX = 25


def schedules(lr0: float, ratio: float, epochs: int) -> dict:
    """Per epoch: AdamW's rate (supervised training and MME's phase F) and
    the SGD rates of MME's phase G for the feature extractor and the
    classifier, each ``CosineAnnealingLR(T_max=25)``."""
    return {
        "adamw": [cosine_annealing(lr0, lr0 / ratio, T_MAX, e)
                  for e in range(epochs)],
        "sgd_fe": [cosine_annealing(lr0 / 3, lr0 * 1e-3, T_MAX, e)
                   for e in range(epochs)],
        "sgd_cls": [cosine_annealing(lr0, lr0 * 1e-3, T_MAX, e)
                    for e in range(epochs)],
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-lr", "--learningRate", type=float, default=1e-3)
    p.add_argument("--lrRatio", type=float, default=1000)
    p.add_argument("--epochs", type=int, default=175)
    p.add_argument("--out", default="lr_schedule.png")
    return p


def main(args=None) -> str:
    args = build_parser().parse_args(args)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lrs = schedules(args.learningRate, args.lrRatio, args.epochs)
    epochs = range(args.epochs)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(epochs, lrs["adamw"], label="AdamW (supervised / MME phase F)")
    ax.plot(epochs, lrs["sgd_fe"], label="SGD featureExtractor (MME phase G)")
    ax.plot(epochs, lrs["sgd_cls"], label="SGD classifier (MME phase G)")
    ax.set_xlabel("epoch")
    ax.set_ylabel("learning rate")
    ax.set_yscale("log")
    ax.legend()
    ax.set_title(f"CosineAnnealingLR(T_max={T_MAX}) schedules")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
