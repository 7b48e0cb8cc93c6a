"""Train MNIST sum-regression ensemble members or the oracle.

    python -m ppde_tpu_torch.scripts.train_binary_mnist_regression \
        [--mnist_source synthetic] [--output_dir D] [--name ensemble_0] \
        [--sum_to 10] [--n_channels 16] [--n_iters 25000] [--device cpu]

Counterpart of ``scripts/train_binary_mnist_regression.py`` (reference
scripts/train_binary_mnist_regression.py:23-129): the same flags and
defaults, plus ``--device`` (``cuda`` by default; raises without a GPU).
AdamW MSE regression on MNIST-sum pairs (``training.train_regression``),
checkpoints ``<output_dir>/<name>_ckpt_<step>.npz`` in the JAX layout,
then the rounding accuracy on the validation pairs. Raw MNIST is not
downloaded: point ``--mnist_source`` at idx/npy files, or use
``synthetic``.
"""
from __future__ import annotations

import argparse
import os

from ppde_tpu_torch import convert, training, utils
from ppde_tpu_torch.data.mnist import MNISTSumPairs


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mnist_source", type=str, default="synthetic")
    p.add_argument("--data_dir", type=str, default=None,
                   help="directory with MNISTsum*.txt pair files")
    p.add_argument("--output_dir", type=str, default="weights/mnist_models")
    p.add_argument("--name", type=str, default="ensemble_0")
    p.add_argument("--sum_to", type=int, default=10, choices=[10, 18])
    p.add_argument("--n_channels", type=int, default=16,
                   help="16 for ensemble members, 64 for the oracle")
    p.add_argument("--n_iters", type=int, default=25000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt_every", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    """Returns (params, validation rounding accuracy)."""
    device = utils.resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    pair_file = (os.path.join(args.data_dir,
                              f"MNISTsum{args.sum_to}_train.txt")
                 if args.data_dir else None)
    train = MNISTSumPairs(args.mnist_source, pair_file, "train",
                          seed=args.seed)
    params = training.train_regression(
        train, nc=args.n_channels, n_iters=args.n_iters,
        batch_size=args.batch_size, lr=args.lr, seed=args.seed,
        ckpt_path=os.path.join(args.output_dir, args.name),
        ckpt_every=args.ckpt_every, device=device)

    val_pairs = (os.path.join(args.data_dir,
                              f"MNISTsum{args.sum_to}_val.txt")
                 if args.data_dir else None)
    val = MNISTSumPairs(args.mnist_source, val_pairs, "val", seed=1,
                        train_noise=False)
    acc = training.eval_regression_accuracy(params, val)
    print(f"val rounding accuracy: {acc:.3f}")
    training.save_ckpt(os.path.join(args.output_dir,
                                    f"{args.name}_ckpt_{args.n_iters}.npz"),
                       convert.mnist_to_numpy(params), args.n_iters)
    return params, acc


if __name__ == "__main__":
    main(build_parser().parse_args())
