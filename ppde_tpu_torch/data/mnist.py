"""MNIST-sum dataset: pairs of digits whose sum is bounded.

A copy of ``ppde_tpu/data/mnist.py`` (numpy only; the port imports nothing
of the JAX package), giving the same arrays from the same sources and
seeds. Parity with the reference dataset (data/mnist.py:9-164 and the Larochelle
binary-MNIST loader used for DAE/EBM training,
third_party/grathwohl/vamp_utils.py): pair indices come from the committed
``MNISTsum{10,18}_{split}.txt`` files; images are dynamically binarized with
optional pixel-flip noise and label noise during training.

Nothing is downloaded: raw MNIST must already exist on disk. ``load_raw_mnist`` accepts:
  * a torchvision-style processed directory,
  * .npy/.npz dumps ({split}_images.npy / {split}_labels.npy),
  * `augmented[:dir]` — real committed MNIST digits (the reference's seed
    images under data/mnist, reference data/mnist/*.npy) expanded by
    label-preserving affine augmentation. The ONLY real MNIST pixels
    available offline; digit identities are unknown, so this source is for
    UNSUPERVISED (EBM/DAE) training — the two validation_*.npy images are
    held out as real calibration data.
  * `synthetic` — a deterministic fake for pipeline tests.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def load_pair_indices(path: str) -> np.ndarray:
    """Parse a MNISTsum*.txt pair-index file: lines of 'i j' (or 'i,j')."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line:
                continue
            a, b = line.split()[:2]
            pairs.append((int(a), int(b)))
    return np.asarray(pairs, np.int64)


def _load_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


SEED_IMAGE_STEMS = ("3_0", "3_1", "29_0", "29_1", "38_0", "38_1",
                    "99_0", "99_1", "149_0", "149_1")
HELDOUT_IMAGE_STEMS = ("validation_0", "validation_1")


def _affine_sample(img: np.ndarray, angle: float, scale: float,
                   shear: float, dx: float, dy: float) -> np.ndarray:
    """Bilinear resample of a 28x28 image under an inverse affine map
    (rotation + isotropic scale + shear + translation about the center).
    Pure numpy; out-of-bounds pixels are 0 (MNIST background)."""
    h, w = img.shape
    c = (h - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    # inverse map: rotate by -angle, scale by 1/scale, unshear, untranslate
    yc, xc = ys - c - dy, xs - c - dx
    ca, sa = np.cos(-angle), np.sin(-angle)
    xr = (ca * xc - sa * yc) / scale
    yr = (sa * xc + ca * yc) / scale
    xr = xr - shear * yr
    ysrc, xsrc = yr + c, xr + c
    y0 = np.floor(ysrc).astype(np.int64)
    x0 = np.floor(xsrc).astype(np.int64)
    fy, fx = ysrc - y0, xsrc - x0

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(ok, img[yy.clip(0, h - 1), xx.clip(0, w - 1)], 0.0)

    out = ((1 - fy) * (1 - fx) * at(y0, x0)
           + (1 - fy) * fx * at(y0, x0 + 1)
           + fy * (1 - fx) * at(y0 + 1, x0)
           + fy * fx * at(y0 + 1, x0 + 1))
    return out.astype(np.float32)


def load_real_seed_images(data_dir: str, heldout: bool = False) -> np.ndarray:
    """The committed real MNIST digits as [N, 28, 28] float32 in [0, 1]."""
    stems = HELDOUT_IMAGE_STEMS if heldout else SEED_IMAGE_STEMS
    return np.stack([np.load(os.path.join(data_dir, s + ".npy"))[0]
                     for s in stems], 0).astype(np.float32)


def augmented_real_mnist(data_dir: str, n: int, seed: int = 0,
                         heldout: bool = False,
                         return_sources: bool = False):
    """[n, 784] affine augmentations of the committed real digits.

    Rotation +-15deg, isotropic scale 0.88-1.12, shear +-0.15, shift +-3 px,
    multiplicative intensity jitter — all digit-identity-preserving, so the
    stroke statistics (width, curvature, continuity) stay real-MNIST.
    """
    base = load_real_seed_images(data_dir, heldout=heldout)
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(base), n)
    out = np.empty((n, 28 * 28), np.float32)
    for i, b in enumerate(which):
        img = _affine_sample(
            base[b],
            angle=rng.uniform(-0.26, 0.26),
            scale=rng.uniform(0.88, 1.12),
            shear=rng.uniform(-0.15, 0.15),
            dx=rng.uniform(-3, 3), dy=rng.uniform(-3, 3))
        img = np.clip(img * rng.uniform(0.9, 1.1), 0.0, 1.0)
        out[i] = img.reshape(-1)
    return (out, which) if return_sources else out


def load_raw_mnist(source: str, split: str = "train"):
    """Return (images [N, 784] float in [0,1], labels [N]).

    source: directory containing either idx files (train-images-idx3-ubyte
    [.gz] etc.), npy dumps, or the literal string 'synthetic'.
    """
    if source.startswith("augmented"):
        data_dir = source.split(":", 1)[1] if ":" in source else "data/mnist"
        n = 8192 if split == "train" else 1024
        # NB: the val split draws augmentations of the TWO HELD-OUT
        # validation_*.npy digits (never seen by train, which augments the
        # 10 seed digits) — a genuinely held-out early-stopping signal;
        # scripts/eval_mnist_ebm.py additionally scores the raw held-out
        # images themselves.
        imgs, which = augmented_real_mnist(data_dir, n,
                                           seed=0 if split == "train" else 1,
                                           heldout=split != "train",
                                           return_sources=True)
        # digit identities of the seed images are unknown: labels are the
        # seed-image INDEX (augmentation provenance), usable only by
        # unsupervised consumers — MNISTSumPairs refuses this source.
        return imgs, which.astype(np.int64)
    if source == "synthetic":
        rng = np.random.default_rng(0 if split == "train" else 1)
        n = 4096 if split == "train" else 1024
        labels = rng.integers(0, 10, n)
        # blocky class-dependent pattern; deterministic
        imgs = np.zeros((n, 28, 28), np.float32)
        for i, lab in enumerate(labels):
            r, c = divmod(int(lab), 4)
            imgs[i, r * 7:(r + 1) * 7 + 7, c * 7:(c + 1) * 7] = 0.9
            imgs[i] += rng.random((28, 28)) * 0.2
        return imgs.reshape(n, 784).clip(0, 1), labels

    prefix = {"train": "train", "val": "train", "test": "t10k"}[split]
    for img_name in (f"{prefix}-images-idx3-ubyte.gz",
                     f"{prefix}-images-idx3-ubyte"):
        p = os.path.join(source, img_name)
        if os.path.exists(p):
            imgs = _load_idx(p).astype(np.float32) / 255.0
            labels = _load_idx(p.replace("images-idx3", "labels-idx1"))
            return imgs.reshape(len(imgs), 784), labels.astype(np.int64)
    npy = os.path.join(source, f"{split}_images.npy")
    if os.path.exists(npy):
        imgs = np.load(npy).astype(np.float32)
        labels = np.load(os.path.join(source, f"{split}_labels.npy"))
        return imgs.reshape(len(imgs), 784), labels
    raise FileNotFoundError(
        f"no raw MNIST under {source!r}; provide idx/npy files or pass "
        "'synthetic'")


class MNISTSumPairs:
    """Iterable batches of (x1, x2, y=digit sum) with training noise.

    Training semantics per the reference MNISTsumTo (data/mnist.py:56-83):
    dynamic binarization (Bernoulli on intensities), per-image pixel-flip
    noise with rate p1,p2 ~ U{0..flip_maxp}% drawn independently for x1 and
    x2 (INDEPENDENT flip masks), and Gaussian label smoothing y ~ N(y, 0.1)
    — training splits only. ``flip_maxp`` defaults to 0 because the
    reference regression trainer forces flip_maxp=0
    (train_binary_mnist_regression.py:234): no flips, only binarization +
    label smoothing.
    """

    def __init__(self, source: str, pair_file: str | None, split: str,
                 seed: int = 0, train_noise: bool | None = None,
                 flip_maxp: int = 0):
        if source.startswith("augmented"):
            raise ValueError(
                "the 'augmented' source has no digit labels (seed-image "
                "identities are unknown) — it serves unsupervised EBM/DAE "
                "training only, not sum-pair supervision")
        self.images, self.labels = load_raw_mnist(source, split)
        self.split = split
        self.train_noise = (split == "train") if train_noise is None \
            else train_noise
        self.flip_maxp = flip_maxp
        self.rng = np.random.default_rng(seed)
        if pair_file is not None and os.path.exists(pair_file):
            self.pairs = load_pair_indices(pair_file)
            self.pairs = self.pairs[(self.pairs < len(self.images)).all(1)]
        else:
            # regenerate pairs with bounded sum (reference data/mnist.py:87+)
            self.pairs = self._make_pairs(sum_to=18 if "18" in str(pair_file)
                                          else 10)

    def _make_pairs(self, sum_to: int, n_pairs: int = 20000) -> np.ndarray:
        idx = self.rng.permutation(len(self.images))
        pairs = []
        half = len(idx) // 2
        for a, b in zip(idx[:half], idx[half:]):
            if self.labels[a] + self.labels[b] <= sum_to:
                pairs.append((a, b))
            if len(pairs) >= n_pairs:
                break
        return np.asarray(pairs, np.int64)

    def __len__(self):
        return len(self.pairs)

    def batches(self, batch_size: int, steps: int | None = None):
        """Yield (x1, x2, y) float32 batches indefinitely (or `steps` times)."""
        count = 0
        while steps is None or count < steps:
            sel = self.rng.integers(0, len(self.pairs), batch_size)
            a, b = self.pairs[sel, 0], self.pairs[sel, 1]
            x1 = self.images[a]
            x2 = self.images[b]
            y = (self.labels[a] + self.labels[b]).astype(np.float32)
            # dynamic binarization
            x1 = (self.rng.random(x1.shape) < x1).astype(np.float32)
            x2 = (self.rng.random(x2.shape) < x2).astype(np.float32)
            if self.train_noise:
                if self.flip_maxp > 0:
                    # per-image flip percent + independent masks per image
                    for x in (x1, x2):
                        p = self.rng.integers(
                            0, self.flip_maxp + 1, (len(x), 1)) / 100.0
                        flip = self.rng.random(x.shape) < p
                        x[flip] = 1.0 - x[flip]
                y = y + 0.1 * self.rng.standard_normal(len(y))
            yield x1, x2, y
            count += 1


def load_static_binary_mnist(source: str, split: str = "train"):
    """Binarized MNIST for DAE/EBM training (the reference uses the
    Larochelle static split, vamp_utils.py:16-79; with no network we
    binarize the local raw MNIST deterministically)."""
    imgs, _ = load_raw_mnist(source, split)
    rng = np.random.default_rng(42)
    return (rng.random(imgs.shape) < imgs).astype(np.float32)
