"""Calibration check of a trained binary-MNIST EBM expert.

    python -m ppde_tpu_torch.scripts.eval_mnist_ebm [--weights_dir W] \
        [--data_dir data/mnist] [--out_dir results/mnist] \
        [--sample_steps 3000] [--device cpu]

Counterpart of ``scripts/eval_mnist_ebm.py``: the same flags and defaults,
plus ``--device`` (``cuda`` by default; raises without a GPU). Loads the
newest ``mnist_ebm_ckpt_*.npz`` of either package's trainer and prints the
energy (unnormalised log-prob) of held-out real digits
(``validation_*.npy``), of their fresh augmentations, and of three
controls (Bernoulli(mean) noise, uniform noise, pixel-shuffled digits),
then runs ``--sample_steps`` Gibbs-with-gradients steps from Bernoulli
noise and scores the samples. The sample grid
(``<out_dir>/ebm_samples.png``) needs matplotlib and is skipped with a
``[skip]`` line without it, as in the JAX script.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ppde_tpu_torch import convert, utils
from ppde_tpu_torch.data import mnist as dmnist
from ppde_tpu_torch.models import mnist_nets
from ppde_tpu_torch.samplers.base import Draws
from ppde_tpu_torch.training import gwg_flip_step


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights_dir", type=str, default="weights/mnist_models")
    p.add_argument("--data_dir", type=str, default="data/mnist")
    p.add_argument("--out_dir", type=str, default="results/mnist")
    p.add_argument("--n_channels", type=int, default=64)
    p.add_argument("--sample_steps", type=int, default=3000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    """Returns {name: (mean, std) of log p} for the five sets and the GWG
    samples, plus the two margins."""
    device = utils.resolve_device(args.device)
    npzs = sorted(glob.glob(os.path.join(args.weights_dir,
                                         "mnist_ebm_ckpt_*.npz")),
                  key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    if not npzs:
        raise FileNotFoundError(f"no mnist_ebm_ckpt_*.npz in "
                                f"{args.weights_dir}")
    mean = np.load(os.path.join(args.data_dir, "mnist_mean.npy")).reshape(-1)
    mean = mean.clip(1e-2, 1 - 1e-2)
    like = mnist_nets.ebm_init(torch.Generator().manual_seed(0),
                               args.n_channels, mean=mean)
    tree, step = mnist_nets.load_npz(npzs[-1], like)
    params = convert.ebm_from_numpy(tree, device)
    print(f"loaded {npzs[-1]} (step {step})")

    @torch.no_grad()
    def logp(x):
        return mnist_nets.ebm_log_prob(
            params, torch.as_tensor(x, dtype=torch.float32,
                                    device=device)).cpu().numpy()

    rng = np.random.default_rng(0)

    def binarize(im):
        return (rng.random(im.shape) < im).astype(np.float32)

    # held-out real digits (never in the training pool)
    real = dmnist.load_real_seed_images(args.data_dir, heldout=True)
    real = binarize(np.tile(real.reshape(-1, 784), (32, 1)))
    # augmentations of the held-out digits (fresh affine draws)
    aug = binarize(dmnist.augmented_real_mnist(args.data_dir, 64, seed=99,
                                               heldout=True))
    # controls
    bern = (rng.random((64, 784)) < mean[None]).astype(np.float32)
    unif = (rng.random((64, 784)) < 0.5).astype(np.float32)
    shuf = real.copy()
    for r in shuf:
        rng.shuffle(r)  # identical ink fraction, destroyed structure

    rows = {}
    for name, x in [("real_heldout", real), ("aug_heldout", aug),
                    ("bernoulli_mean", bern), ("uniform", unif),
                    ("pixel_shuffled", shuf)]:
        v = logp(x)
        rows[name] = (float(v.mean()), float(v.std()))
        print(f"logp {name:15s} mean {v.mean():9.1f} +- {v.std():6.1f}")

    margin_bern = rows["real_heldout"][0] - rows["bernoulli_mean"][0]
    margin_shuf = rows["real_heldout"][0] - rows["pixel_shuffled"][0]
    print(f"margin real-vs-bernoulli {margin_bern:.1f}  "
          f"real-vs-shuffled {margin_shuf:.1f}")

    # GWG samples from the model
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    x = torch.from_numpy((rng.random((64, 784)) < mean[None]).astype(
        np.float32)).to(device)
    for _ in range(args.sample_steps):
        x = gwg_flip_step(params, x, draws, mnist_nets.ebm_log_prob)
    x = x.cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(8, 8, figsize=(8, 8))
        for i, ax in enumerate(axes.ravel()):
            ax.imshow(x[i].reshape(28, 28), cmap="gray_r")
            ax.axis("off")
        fig.suptitle(f"EBM GWG samples ({args.sample_steps} steps)")
        fig.tight_layout()
        out = os.path.join(args.out_dir, "ebm_samples.png")
        fig.savefig(out, dpi=120)
        print(f"sample grid -> {out}")
    except Exception as e:  # matplotlib optional, as in the JAX script
        print(f"[skip] sample grid: {e}")
    v = logp(x)
    rows["gwg_samples"] = (float(v.mean()), float(v.std()))
    print(f"logp gwg_samples     mean {v.mean():9.1f} +- {v.std():6.1f}")
    rows["margin_real_vs_bernoulli"] = margin_bern
    rows["margin_real_vs_shuffled"] = margin_shuf
    return rows


if __name__ == "__main__":
    main(build_parser().parse_args())
