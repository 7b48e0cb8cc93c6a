"""Train the binary-MNIST denoising autoencoder expert.

    python -m ppde_tpu_torch.scripts.train_binary_mnist_dae \
        [--mnist_source augmented:data/mnist] [--output_dir D] \
        [--n_iters 40000] [--ckpt_path RESUME.npz] [--device cpu]

Counterpart of ``scripts/train_binary_mnist_dae.py`` (reference
scripts/train_binary_mnist_dae.py:60-96): the same flags and defaults, plus
``--device`` (``cuda`` by default; raises without a GPU). Corrupt ->
reconstruct BCE (``training.train_dae``) with checkpoints
``<output_dir>/mnist_binary_dae_ckpt_<step>.npz`` in the JAX layout, which
both packages' ``mnist_sum`` load; ``--ckpt_path`` resumes.
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
    p.add_argument("--latent_dim", type=int, default=16)
    p.add_argument("--n_channels", type=int, default=64)
    p.add_argument("--max_p", type=int, default=15)
    p.add_argument("--n_iters", type=int, default=40000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--ckpt_path", type=str, default=None, help="resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    device = utils.resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    images = load_static_binary_mnist(args.mnist_source, "train")
    return training.train_dae(
        images, latent_dim=args.latent_dim, n_channels=args.n_channels,
        max_p=args.max_p, n_iters=args.n_iters, batch_size=args.batch_size,
        lr=args.lr, seed=args.seed, resume=args.ckpt_path,
        ckpt_path=os.path.join(args.output_dir, "mnist_binary_dae"),
        ckpt_every=args.ckpt_every, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
