"""Population metrics of a run's summary, and the MNIST run's writers.

Counterpart of ``diversity_pct``, ``exploration`` (reference
make_figures.py:29-49) and the MNIST writers (reference metrics.py:103-134,
mnist_sum.py:36-58) of ``ppde_tpu/metrics.py``. The CSVs are written with
numpy in pandas' ``to_csv`` layout (no pandas needed); the plots, the GIF
and the population grid import matplotlib or PIL when called
(``WRITER_PACKAGES`` names which). The rest of that module (Potts and
MSA-Transformer scoring) waits for the metrics port.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ppde_tpu_torch import codec, utils


def diversity_pct(population: np.ndarray) -> float:
    """% unique variants of a one-hot population [N, L, V]."""
    seqs = codec.onehot_to_seqs(population)
    return 100.0 * len(set(seqs)) / len(seqs)


def exploration(population: np.ndarray, wt_onehot: np.ndarray):
    """(mean, std) number of mutations from the wild type."""
    d = utils.mut_distance(torch.as_tensor(np.asarray(population)),
                           torch.as_tensor(np.asarray(wt_onehot))).numpy()
    return float(d.mean()), float(d.std())


# ---------------------------------------------------------------------------
# MNIST run artifacts
# ---------------------------------------------------------------------------

QUANTS = [0.5, 0.6, 0.7, 0.8, 0.9]
# the package each image writer of --metrics imports ("csv" needs none)
WRITER_PACKAGES = {"plots": "matplotlib", "viz": "matplotlib", "gif": "PIL"}


def _log_steps(n_rows: int, args) -> np.ndarray:
    # clamp the tail: the last record sits at n_iters when the final
    # segment is ragged (n_iters % log_every != 0)
    return np.minimum(np.arange(n_rows) * args.log_every, args.n_iters)


def _csv_number(v) -> str:
    return "" if np.isnan(v) else repr(float(v))


def mnist_scores_to_csv(pred_scores, oracle_scores, method: str, args):
    """{method}_pred_sums.csv and {method}_oracle_sums.csv: per log step
    the population's QUANTS quantiles, in pandas' ``to_csv`` layout (a
    header ``,0.5,...,0.9``, the step as the index column)."""
    xs = _log_steps(pred_scores.shape[0], args)
    for name, scores in [("pred_sums", pred_scores),
                         ("oracle_sums", oracle_scores)]:
        q = np.quantile(scores, QUANTS, axis=1).T
        lines = ["," + ",".join(str(c) for c in QUANTS)]
        lines += [f"{x}," + ",".join(_csv_number(v) for v in row)
                  for x, row in zip(xs, q)]
        with open(os.path.join(args.results_path, f"{method}_{name}.csv"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def mnist_performance_plots(pred_scores, oracle_scores, method: str, args):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = _log_steps(pred_scores.shape[0], args)
    pq = np.quantile(pred_scores, QUANTS, axis=1)
    oq = np.quantile(oracle_scores, QUANTS, axis=1)
    plt.figure()
    plt.plot(xs, pq[2], label="pred.", linestyle="--")
    plt.fill_between(xs, pq[0], pq[-1], alpha=0.1, linewidth=1)
    plt.plot(xs, oq[2], label="oracle")
    plt.fill_between(xs, oq[0], oq[-1], alpha=0.1, linewidth=1)
    plt.legend(loc="center left", bbox_to_anchor=(1.0, 0.5))
    plt.xlabel("step")
    plt.ylabel("sum")
    plt.tight_layout()
    for ext in ("pdf", "png"):
        plt.savefig(os.path.join(args.results_path, f"{method}_scores.{ext}"))
    plt.close()


def make_gif(traj, method: str, args):
    """Evolution GIF of one chain (reference mnist_sum.py:36-45)."""
    from PIL import Image

    frames = [Image.fromarray((255 * t.reshape(28, 28)).astype(np.uint8))
              .convert("P") for t in traj]
    frames[0].save(os.path.join(args.results_path, f"{method}.gif"),
                   save_all=True, append_images=frames[1:], duration=100,
                   loop=0)


def visualize_population(population, method: str, args):
    """Final-population grid image (reference mnist_sum.py:47-58)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = population.reshape(-1, 28, 28)
    cols = 8
    rows = (imgs.shape[0] + cols - 1) // cols
    grid = np.ones((rows * 30 + 2, cols * 30 + 2))
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * 30 + 2: r * 30 + 30, c * 30 + 2: c * 30 + 30] = im
    plt.figure(figsize=(6, 10))
    plt.imshow(grid, cmap="gray")
    plt.axis("off")
    for ext in ("pdf", "png"):
        plt.savefig(os.path.join(args.results_path,
                                 f"{method}_final_population.{ext}"))
    plt.close()
    np.save(os.path.join(args.results_path, f"{method}_final_population.npy"),
            imgs)
