"""Write MNIST weights and data directories of seeded stand-ins.

    python -m ppde_tpu_torch.scripts.seeded_mnist --weights DIR \
        --data DIR [--seed 0]

makes what ``scripts/mnist_sum.py`` (both packages' CLIs) reads:

  * in the weights directory, the 3 regression members
    ``ensemble_{i}_ckpt_25000.pt`` (nc = 16) and the oracle
    ``one-hot_GT_ckpt_60000.pt``, seeded, in the reference state-dict
    layout (``net.{0,2,4,6}.*``, ``out.*``), and copies of the tracked
    trainer checkpoints ``mnist_ebm_ckpt_20000.npz`` and
    ``mnist_binary_dae_ckpt_40000.npz``;
  * in the data directory, the six wild-type pairs of ``WT_FILES``:
    binary [1, 28, 28] images from a numpy seed, each with 13-19% ones (the
    density of binarised MNIST digits), which are also the ten seed digits
    and the two held-out ``validation_*`` digits that ``data/mnist.py``'s
    ``augmented`` source and ``eval_mnist_ebm`` read, and
    ``mnist_mean.npy``, the tracked EBM checkpoint's own Bernoulli mean.

The reference's regression ensemble, oracle, wild-type digits and
``mnist_mean.npy`` are not in the repository; runs on these stand-ins can be
compared between the packages, not with the paper.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from ppde_tpu_torch.models import mnist_nets, torch_convert
from ppde_tpu_torch.scripts.mnist_sum import WT_FILES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
TRACKED = os.path.join(REPO, "weights", "mnist_models")
NPZ_FILES = ("mnist_ebm_ckpt_20000.npz", "mnist_binary_dae_ckpt_40000.npz")
EBM_MEAN_LEAF = "p38"  # the mean in the EBM checkpoint's JAX flatten order


def write_weights_dir(out: str, seed: int = 0, nc: int = 16) -> str:
    os.makedirs(out, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    for i in range(3):
        torch_convert.save_mnist_regression(
            os.path.join(out, f"ensemble_{i}_ckpt_25000.pt"),
            mnist_nets.regression_init(gen, nc))
    torch_convert.save_mnist_regression(
        os.path.join(out, "one-hot_GT_ckpt_60000.pt"),
        mnist_nets.regression_init(gen, nc))
    for f in NPZ_FILES:
        shutil.copyfile(os.path.join(TRACKED, f), os.path.join(out, f))
    return out


def write_data_dir(out: str, seed: int = 0) -> str:
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    for pair in WT_FILES.values():
        for f in pair:
            density = rng.uniform(0.13, 0.19)
            img = np.zeros(784, np.float32)
            img[rng.choice(784, int(round(density * 784)), replace=False)] = 1
            np.save(os.path.join(out, f), img.reshape(1, 28, 28))
    mean = np.load(os.path.join(TRACKED, NPZ_FILES[0]))[EBM_MEAN_LEAF]
    np.save(os.path.join(out, "mnist_mean.npy"), mean)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(write_weights_dir(args.weights, args.seed))
    print(write_data_dir(args.data, args.seed))


if __name__ == "__main__":
    main()
