"""Train the binary-MNIST ResNet EBM expert.

    python -m ppde_tpu_torch.scripts.train_binary_mnist_ebm \
        [--mnist_source augmented:data/mnist] [--output_dir D] \
        [--n_iters 10000] [--device cpu]

Counterpart of ``scripts/train_binary_mnist_ebm.py``: the same flags and
defaults, plus ``--device`` (``cuda`` by default; raises without a GPU).
Persistent contrastive divergence with Gibbs-with-gradients buffer updates
(``training.train_ebm``), checkpoints
``<output_dir>/mnist_ebm_ckpt_<step>.npz`` in the JAX layout, which both
packages' ``mnist_sum`` and ``eval_mnist_ebm`` load.
"""
from __future__ import annotations

import argparse
import os

from ppde_tpu_torch import training, utils
from ppde_tpu_torch.data.mnist import load_static_binary_mnist


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mnist_source", type=str,
                   default="augmented:data/mnist",
                   help="'augmented[:dir]' = affine-augmented real MNIST "
                        "seed digits; a raw-MNIST directory; or "
                        "'synthetic' (pipeline tests)")
    p.add_argument("--output_dir", type=str, default="weights/mnist_models")
    p.add_argument("--n_channels", type=int, default=64)
    p.add_argument("--n_iters", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--buffer_size", type=int, default=1000)
    p.add_argument("--sampling_steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--p_control", type=float, default=5e-2)
    p.add_argument("--reinit_p", type=float, default=0.05)
    p.add_argument("--data_noise_p", type=float, default=0.03)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    device = utils.resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    images = load_static_binary_mnist(args.mnist_source, "train")
    return training.train_ebm(
        images, n_channels=args.n_channels, n_iters=args.n_iters,
        batch_size=args.batch_size, buffer_size=args.buffer_size,
        sampling_steps=args.sampling_steps, lr=args.lr, seed=args.seed,
        p_control=args.p_control, reinit_p=args.reinit_p,
        data_noise_p=args.data_noise_p,
        ckpt_path=os.path.join(args.output_dir, "mnist_ebm"),
        ckpt_every=args.ckpt_every, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
