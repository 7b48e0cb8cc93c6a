"""Evaluation metrics and artifact writers.

Counterpart of ``ppde_tpu/metrics.py``:
  * proteins_potts_score: delta Hamiltonian of a population (reference
    metrics.py:14-19);
  * proteins_transformer_score: MSA-Transformer masked-marginal
    evolutionary density (reference metrics.py:22-76), one forward per
    unique mutated column instead of one per (variant, mutation) pair;
  * population diversity / exploration (reference make_figures.py:29-49);
    n_hops (reference metrics.py:78-85) is in ``utils``;
  * the MNIST writers (reference metrics.py:103-134, mnist_sum.py:36-58).
The CSVs are written with numpy in pandas' ``to_csv`` layout (no pandas
needed); the plots, the GIF and the population grid import matplotlib or
PIL when called (``WRITER_PACKAGES`` names which).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, utils


def proteins_potts_score(population: np.ndarray, protein_dir: str,
                         device="cuda") -> np.ndarray:
    """Delta-Hamiltonian of a one-hot population [N, L, 20] under the
    protein directory's Potts model (``runtime.load_potts``)."""
    from ppde_tpu_torch import runtime
    from ppde_tpu_torch.models import potts as potts_mod

    device = utils.resolve_device(device)
    pp = runtime.load_potts(protein_dir, device=device)
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(population, np.float32), device=device)
        return potts_mod.score(pp, x, delta=True).cpu().numpy()


def diversity_pct(population: np.ndarray) -> float:
    """% unique variants of a one-hot population [N, L, V]."""
    seqs = codec.onehot_to_seqs(population)
    return 100.0 * len(set(seqs)) / len(seqs)


def exploration(population: np.ndarray, wt_onehot: np.ndarray):
    """(mean, std) number of mutations from the wild type."""
    d = utils.mut_distance(torch.as_tensor(np.asarray(population)),
                           torch.as_tensor(np.asarray(wt_onehot))).numpy()
    return float(d.mean()), float(d.std())


def proteins_transformer_score(population: np.ndarray, protein_dir: str,
                               msa_location: str, msa_size: int,
                               weights_path: str | None = None,
                               allow_random: bool = False,
                               seed: int = 0,
                               msa_model: str = "msa-1b",
                               device="cuda") -> np.ndarray:
    """Evolutionary density via MSA-Transformer masked marginals.

    For each variant, for each of its mutations inside the Potts window:
    mask that column in the WT row of a [msa_size, window] alignment, run
    the MSA Transformer, accumulate log p(mut) - log p(wt). Mutation effects
    are taken as additive (reference metrics.py:40-76), so each unique
    mutated column costs one forward however many variants mutate it; a
    variant with no mutation in the window scores 0.0.

    The context rows are the JAX package's draw: ``msa_size - 1`` rows of
    the alignment without replacement from ``np.random.default_rng(seed)``.
    ``msa_model``: msa_transformer.CONFIGS key ("msa-1b" for a converted
    fair-esm checkpoint, or a smaller config's family-trained .npz).
    """
    from ppde_tpu_torch import runtime
    from ppde_tpu_torch.models import msa_transformer as msat

    device = utils.resolve_device(device)
    pp = runtime.load_potts(protein_dir, device=device)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    lo, hi = pp.min_pos, pp.max_pos

    msa = pio.load_msa(msa_location)
    rng = np.random.default_rng(seed)
    idxs = rng.choice(len(msa), size=min(msa_size - 1, len(msa)),
                      replace=False)
    msa_rows = [msa[i][1] for i in idxs]

    params = msat.load(weights_path, allow_random=allow_random,
                       name=msa_model, device=device)

    seqs = codec.onehot_to_seqs(population)
    # per-variant mutations inside the window, and the unique masked columns
    muts_per_variant = []
    needed_cols = set()
    for s in seqs:
        muts = [(i, wt[i], s[i]) for i in range(len(wt))
                if s[i] != wt[i] and lo <= i <= hi]
        muts_per_variant.append(muts)
        needed_cols.update(i for i, _, _ in muts)

    if not needed_cols:
        return np.zeros(len(seqs))

    cols = sorted(needed_cols)
    logp = msat.masked_marginals(params, wt[lo:hi + 1], msa_rows,
                                 [c - lo for c in cols],
                                 heads=msat.heads_of(msa_model))
    col_to_row = {c: k for k, c in enumerate(cols)}

    scores = np.zeros(len(seqs))
    for v, muts in enumerate(muts_per_variant):
        total = 0.0
        for (i, wt_aa, mut_aa) in muts:
            row = logp[col_to_row[i]]
            total += float(row[msat.ESM_TOK_TO_IDX[mut_aa]]
                           - row[msat.ESM_TOK_TO_IDX[wt_aa]])
        scores[v] = total
    return scores


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
