"""Training loops for the experts: the ESM2 and MSA-Transformer masked-LM
trainers, the MNIST sum-regression ensembles, the binary-MNIST DAE and EBM.

Counterpart of ``ppde_tpu/training.py`` with the same names and defaults.

  * The optimizer is optax's chain written over lists of tensors with
    ``torch._foreach_*`` ops (a few multi-tensor launches a step, whatever
    the number of leaves): ``clip_by_global_norm``, ``adam`` and ``adamw``
    with a decay mask (leaves of two or more dims), and the schedules the
    trainers use (``warmup_cosine_decay_schedule``,
    ``cosine_decay_schedule``), evaluated at the step count before the
    update as optax does: a warmup from 0 moves no weight on the first
    step but updates Adam's moments.
  * A step is a Python loop iteration on the device (the JAX package runs a
    ``lax.scan`` of ``chunk`` steps); the datasets stay on the device, and
    the loss goes to the host once a chunk at most, when it is printed: the
    printed loss is the mean over the last chunk, as in the JAX package.
  * Every random number a step uses comes from a ``TrainDraws`` (one
    ``torch.Generator`` on the device); each trainer's docstring gives the
    order, so that a test can replay the JAX package's draws through an
    object with the same methods.
  * Checkpoints are ``save_ckpt`` npz files: leaves ``p0..pN`` in the JAX
    package's flatten order (dict keys sorted) plus ``step``, which either
    package's loaders read. MNIST trees are written in the JAX layout (HWIO
    kernels; ``convert.mnist_to_numpy``).

The ESM2 forward and backward go through kernels C and C' on a CUDA tensor
(``models/esm2.py``); everything else is plain PyTorch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ppde_tpu_torch import convert, utils
from ppde_tpu_torch.models import esm2, mnist_nets
from ppde_tpu_torch.parallel import mesh as pmesh
from ppde_tpu_torch.samplers.base import Draws


# ---------------------------------------------------------------------------
# optax's schedules and optimizers
# ---------------------------------------------------------------------------

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule: init * ((1 - alpha) * 0.5 * (1 +
    cos(pi * min(t, T) / T)) + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)

    return schedule


class Adam:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay, mask=decay_mask)) over a list of float tensors;
    ``clip_norm=None`` drops the clip and ``weight_decay=0`` gives
    optax.adam. The count starts at 0: the first update uses
    ``schedule(0)``.

    The arithmetic is optax's: clip by ``max / |g|`` only when ``|g| >=
    max`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), moments
    ``b * m + (1 - b) * g``, bias-corrected, ``m / (sqrt(v) + eps)``, plus
    ``weight_decay * p`` on the masked leaves, times ``-lr``. The rounding
    order differs in places (the clip multiplies by one factor; the
    learning rate is a host float)."""

    def __init__(self, leaves: list, schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decay_mask=None,
                 clip_norm: float | None = None):
        self.leaves = list(leaves)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        mask = decay_mask if decay_mask is not None else [True] * len(
            self.leaves)
        self.decay_idx = [i for i, m in enumerate(mask) if m]
        self.clip_norm = clip_norm
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        """Update ``leaves`` in place from ``grads`` (same order; None is a
        zero gradient)."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - b2)
        self.count += 1
        m_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(
            torch._foreach_div(self.nu, 1.0 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m_hat, denom)
        if self.weight_decay:
            torch._foreach_add_([upd[i] for i in self.decay_idx],
                                [self.leaves[i] for i in self.decay_idx],
                                alpha=self.weight_decay)
        torch._foreach_add_(self.leaves, upd, alpha=-lr)


class TrainDraws(Draws):
    """``Draws`` plus the row draw of the trainers' batches."""

    def rows(self, weights, n: int) -> torch.Tensor:
        """[n] row indices drawn with replacement, with probability
        proportional to ``weights`` (a tensor of row weights, or an int:
        the row count, drawn uniformly)."""
        if isinstance(weights, int):
            return self.randint(weights, (n,))
        return torch.multinomial(weights, n, replacement=True,
                                 generator=self.generator)


def _draws(draws, device, seed: int):
    return draws if draws is not None else TrainDraws(
        torch.Generator(device=device).manual_seed(seed))


# ---------------------------------------------------------------------------
# checkpoints and chunking
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def save_ckpt(path: str, params, step: int):
    """Leaves ``p0..pN`` in the JAX package's flatten order (dict keys
    sorted, lists in order) plus ``step``; bf16 leaves are written as
    float32. The JAX package also writes a ``treedef`` string, which no
    loader of either package reads."""
    flat = esm2._flatten(params)
    np.savez_compressed(path, step=step,
                        **{f"p{i}": _host(a) for i, a in enumerate(flat)})


def load_ckpt(path: str, params_like):
    """(``params_like`` with its leaves read from ``path``, each on its
    like's device and in its type; the step)."""
    z = np.load(path, allow_pickle=False)
    like = esm2._flatten(params_like)
    leaves = [torch.from_numpy(np.array(z[f"p{i}"])).to(a.device, a.dtype)
              for i, a in enumerate(like)]
    return esm2._unflatten(params_like, leaves), int(z["step"])


def _chunked(n_iters: int, chunk: int, *cadences: int, start: int = 0):
    """Yield (done, size) chunks, sized so every log/checkpoint cadence
    boundary lands exactly on a chunk boundary (a chunk is shortened to end
    at the next boundary). ``start``: absolute step offset of done=0
    (resumed runs), so boundaries stay aligned to absolute steps."""
    done = 0
    while done < n_iters:
        size = min(chunk, n_iters - done)
        for c in cadences:
            if c > 0:
                size = min(size, c - (start + done) % c)
        yield done, size
        done += size


def _trainable(tree) -> list:
    """The tree's leaves, each made a leaf that requires grad (in place)."""
    leaves = esm2._flatten(tree)
    for a in leaves:
        a.requires_grad_(True)
    return leaves


def _detached(tree):
    return esm2._map_leaves(tree, lambda _, a: a.detach())


def _master_f32(params, device=None):
    """A float32 master copy of a parameter tree (other types kept), on
    ``device`` (None: where each leaf is)."""
    def leaf(_, a):
        a = a.detach().to(device if device is not None else a.device)
        return (a.float() if a.is_floating_point() else a).clone()

    return esm2._map_leaves(params, leaf)


def _log_due(step: int, every: int, n_iters: int) -> bool:
    return step % every == 0 or step == n_iters


# ---------------------------------------------------------------------------
# MNIST sum regression (ensemble members and the oracle)
# ---------------------------------------------------------------------------

def train_regression(dataset, nc: int = 16, n_iters: int = 25000,
                     batch_size: int = 128, lr: float = 1e-3,
                     weight_decay: float = 1e-4, seed: int = 0,
                     log_every: int = 1000, ckpt_path: str | None = None,
                     ckpt_every: int = 5000, quiet: bool = False,
                     chunk: int = 250, flip_maxp: int = 0, device="cuda",
                     draws=None):
    """AdamW MSE regression of the digit sum on ``dataset`` (an
    ``MNISTSumPairs``: images, labels and pairs go on the device).

    A step draws, in order: ``randint(n_pairs, [B])`` (the pairs),
    ``uniform([B, 784])`` twice (the binarisations of x1, x2); with the
    dataset's ``train_noise``: if ``flip_maxp`` > 0, ``randint(flip_maxp
    + 1, [B, 1])`` twice (per-image flip percent) and ``uniform([B, 784])``
    twice (independent masks); then ``normal([B])`` (label noise, sd
    0.1)."""
    device = utils.resolve_device(device)
    params = mnist_nets.regression_init(
        torch.Generator(device=device).manual_seed(seed), nc=nc)
    leaves = _trainable(params)
    opt = Adam(leaves, lambda _: lr, weight_decay=weight_decay)

    images = torch.as_tensor(dataset.images, dtype=torch.float32,
                             device=device)
    labels = torch.as_tensor(dataset.labels, dtype=torch.float32,
                             device=device)
    pairs = torch.as_tensor(dataset.pairs, device=device)
    draws = _draws(draws, device, seed + 1)
    B, D = batch_size, images.shape[1]

    def one_step():
        sel = draws.randint(pairs.shape[0], (B,))
        a, b = pairs[sel, 0], pairs[sel, 1]
        x1 = (draws.uniform((B, D)) < images[a]).float()
        x2 = (draws.uniform((B, D)) < images[b]).float()
        y = labels[a] + labels[b]
        if dataset.train_noise:
            if flip_maxp > 0:
                p1 = draws.randint(flip_maxp + 1, (B, 1)) / 100.0
                p2 = draws.randint(flip_maxp + 1, (B, 1)) / 100.0
                f1 = draws.uniform((B, D)) < p1
                f2 = draws.uniform((B, D)) < p2
                x1 = torch.where(f1, 1.0 - x1, x1)
                x2 = torch.where(f2, 1.0 - x2, x2)
            y = y + 0.1 * draws.normal((B,))
        loss = ((mnist_nets.regression_apply(params, x1, x2) - y) ** 2).mean()
        opt.step(torch.autograd.grad(loss, leaves))
        return loss.detach()

    for done, size in _chunked(n_iters, chunk, log_every, ckpt_every):
        loss = torch.stack([one_step() for _ in range(size)]).mean()
        step = done + size
        if not quiet and _log_due(step, log_every, n_iters):
            print(f"[regression] iter {step} mse {float(loss):.4f}",
                  flush=True)
        if ckpt_path and _log_due(step, ckpt_every, n_iters):
            save_ckpt(f"{ckpt_path}_ckpt_{step}.npz",
                      convert.mnist_to_numpy(params), step)
    return _detached(params)


@torch.no_grad()
def eval_regression_accuracy(params, dataset, n_batches: int = 20,
                             batch_size: int = 256):
    """Rounding accuracy (reference train_binary_mnist_regression.py:
    98-129); the batches come from the dataset's numpy generator."""
    device = params["out"]["w"].device
    correct = total = 0
    for x1, x2, y in dataset.batches(batch_size, steps=n_batches):
        pred = mnist_nets.regression_apply(
            params, torch.from_numpy(x1).to(device),
            torch.from_numpy(x2).to(device)).cpu().numpy()
        correct += (np.round(pred) == y).sum()
        total += len(y)
    return correct / total


# ---------------------------------------------------------------------------
# DAE
# ---------------------------------------------------------------------------

def train_dae(images: np.ndarray, latent_dim: int = 16, n_channels: int = 64,
              max_p: int = 15, n_iters: int = 40000, batch_size: int = 128,
              lr: float = 1e-3, seed: int = 0, log_every: int = 1000,
              ckpt_path: str | None = None, ckpt_every: int = 10000,
              resume: str | None = None, quiet: bool = False,
              chunk: int = 250, device="cuda", draws=None):
    """Corrupt -> reconstruct BCE with Adam. A step draws ``randint(N,
    [B])`` (the batch), then ``mnist_nets.dae_corrupt``'s ``randint(max_p
    + 1, [])`` and ``uniform([B, 784])``. ``resume``: a checkpoint of
    either package's trainer (JAX layout); the optimizer starts afresh, as
    in the JAX package."""
    device = utils.resolve_device(device)
    params = mnist_nets.dae_init(
        torch.Generator(device=device).manual_seed(seed), latent_dim,
        n_channels)
    start = 0
    if resume:
        tree, start = mnist_nets.load_npz(resume, params)
        params = convert.dae_from_numpy(tree, device)
    leaves = _trainable(params)
    opt = Adam(leaves, lambda _: lr)

    data = torch.as_tensor(images, dtype=torch.float32, device=device)
    draws = _draws(draws, device, seed + 1)

    def one_step():
        x = data[draws.randint(data.shape[0], (batch_size,))]
        noised = mnist_nets.dae_corrupt(draws, x, max_p)
        logits = mnist_nets.dae_logits(params, noised)
        loss = F.binary_cross_entropy_with_logits(
            logits, x, reduction="none").sum(-1).mean()
        opt.step(torch.autograd.grad(loss, leaves))
        return loss.detach()

    for done, size in _chunked(n_iters - start, chunk, log_every,
                               ckpt_every, start=start):
        loss = torch.stack([one_step() for _ in range(size)]).mean()
        step = start + done + size
        if not quiet and _log_due(step, log_every, n_iters):
            print(f"[dae] iter {step} bce {float(loss):.3f}", flush=True)
        if ckpt_path and _log_due(step, ckpt_every, n_iters):
            save_ckpt(f"{ckpt_path}_ckpt_{step}.npz",
                      convert.mnist_to_numpy(params), step)
    return _detached(params)


# ---------------------------------------------------------------------------
# ESM2 masked-LM fine-tuning (family-specific transformer experts)
# ---------------------------------------------------------------------------

def _esm_tokens(seqs) -> np.ndarray:
    """Equal-length AA strings (or a ready int array) -> tokens [M, T]."""
    if isinstance(seqs, np.ndarray):
        toks = np.asarray(seqs, np.int32)
    else:
        unk = esm2.ESM_TOK_TO_IDX["<unk>"]
        toks = np.asarray(
            [[esm2.ESM_TOK_TO_IDX.get(c, unk) for c in s] for s in seqs],
            np.int32)
    if toks.ndim != 2:
        raise ValueError("seqs must be equal-length (aligned) sequences")
    return toks


AA_LO = esm2.ESM_TOK_TO_IDX["L"]  # the canonical amino acids' token range
AA_HI = esm2.ESM_TOK_TO_IDX["C"]


def _esm_corrupt(draws, tok: torch.Tensor, mask_prob: float):
    """BERT/ESM 80/10/10 corruption: -> (corrupted tokens, selected mask).
    Draws ``uniform(tok.shape)`` (selection), ``uniform(tok.shape)`` (which
    of the three) and ``randint(AA_HI - AA_LO + 1, tok.shape)`` (the random
    amino acid, from L to C)."""
    is_sel = draws.uniform(tok.shape) < mask_prob
    r = draws.uniform(tok.shape)
    rnd = AA_LO + draws.randint(AA_HI - AA_LO + 1, tok.shape)
    corrupt = torch.where(
        is_sel & (r < 0.8), esm2.MASK_IDX,
        torch.where(is_sel & (r >= 0.9), rnd.to(tok.dtype), tok))
    return corrupt, is_sel


def _masked_ce_sums(logits: torch.Tensor, tok: torch.Tensor,
                    is_sel: torch.Tensor):
    """(sum of the cross-entropy at selected positions, their count)."""
    lp = torch.log_softmax(logits, -1)
    ce = -lp.gather(-1, tok.long()[..., None])[..., 0]
    w = is_sel.float()
    return (ce * w).sum(), w.sum()


@torch.no_grad()
def esm_mlm_heldout_ce(params, seqs, name: str = "transformer-S",
                       mask_prob: float = 0.15, seed: int = 0,
                       n_repeats: int = 4, compute_dtype=torch.bfloat16,
                       draws=None) -> float:
    """Mean masked-LM cross-entropy of ``params`` on held-out sequences
    (the validation metric of ``train_esm_mlm``): the same corruption with
    masks from ``seed``, ``n_repeats`` draws, each one forward of all the
    sequences, on the device of ``params`` (JAX's ``remat`` argument is
    gone: a forward without gradient keeps no activations)."""
    device = params["embed"].device
    tok = torch.from_numpy(_esm_tokens(seqs)).to(device, torch.long)
    heads = esm2.CONFIGS[name]["heads"]
    cparams = esm2.cast_params(params, compute_dtype)
    draws = _draws(draws, device, seed)
    num = torch.zeros((), device=device)
    den = torch.zeros((), device=device)
    for _ in range(n_repeats):
        corrupt, is_sel = _esm_corrupt(draws, tok, mask_prob)
        x = F.one_hot(corrupt, esm2.ESM_VOCAB).float()
        n, d = _masked_ce_sums(esm2.forward_logits(cparams, x, heads), tok,
                               is_sel)
        num, den = num + n, den + d
    return float(num / den.clamp_min(1.0))


def _mlm_sums(params, tok, corrupt, is_sel, heads, compute_dtype, remat):
    """``_masked_ce_sums`` of the logits of the corrupted batch under
    ``params`` cast to ``compute_dtype``."""
    x = F.one_hot(corrupt, esm2.ESM_VOCAB).float()
    logits = esm2.forward_logits(esm2.cast_params(params, compute_dtype), x,
                                 heads, remat)
    return _masked_ce_sums(logits, tok, is_sel)


def esm_mlm_loss(params, tok: torch.Tensor, corrupt: torch.Tensor,
                 is_sel: torch.Tensor, heads: int,
                 compute_dtype=torch.bfloat16, remat: bool = False):
    """The masked-LM loss of one batch: mean cross-entropy of the original
    tokens ``tok`` at the selected positions, from the logits of the
    corrupted batch under ``params`` cast to ``compute_dtype``."""
    num, den = _mlm_sums(params, tok, corrupt, is_sel, heads, compute_dtype,
                         remat)
    return num / den.clamp_min(1.0)


def _row_weights(seq_weights, n_rows: int, device, what: str):
    """The row draw's weights (an int n_rows: uniform)."""
    if seq_weights is None:
        return n_rows
    if len(seq_weights) != n_rows:
        raise ValueError(f"seq_weights has {len(seq_weights)} entries for "
                         f"{n_rows} {what}")
    return torch.as_tensor(np.asarray(seq_weights, np.float32),
                           device=device).clamp_min(1e-30)


def train_esm_mlm(seqs, name: str = "transformer-S", params=None,
                  n_iters: int = 2000, batch_size: int = 32,
                  lr: float = 1e-4, warmup: int = 100,
                  weight_decay: float = 0.01, mask_prob: float = 0.15,
                  seed: int = 0, log_every: int = 100,
                  ckpt_path: str | None = None, ckpt_every: int = 1000,
                  resume: str | None = None, quiet: bool = False,
                  chunk: int = 25, compute_dtype=torch.bfloat16,
                  remat: bool | None = None, seq_weights=None,
                  lora_rank: int = 0, lora_alpha: float = 16.0,
                  device="cuda", draws=None, mesh=None):
    """Fine-tune (or pretrain) an ESM2 expert on a sequence family with the
    BERT/ESM masked-LM objective (``ppde_tpu/training.py``'s
    ``train_esm_mlm``).

    * ``seqs``: equal-length AA strings in the expert's format (no
      cls/eos) or an int token array [M, T]; the tokens stay on the device.
    * A step draws ``rows(weights, batch_size)`` (rows with replacement,
      proportional to ``seq_weights``; uniform when None), then
      ``_esm_corrupt``'s three draws over the batch.
    * float32 master parameters and optimizer state; the loss casts them
      to ``compute_dtype`` with ``esm2.cast_params`` (layer norms and the
      LM bias stay float32), so rounding happens where the JAX package
      rounds. clip_by_global_norm(1.0), then AdamW with a warmup-cosine
      schedule (0 -> lr over ``warmup``, to 0.1 lr at ``max(n_iters,
      warmup + 1)``) and weight decay on leaves of two or more dims.
    * ``remat``: None = on for transformer-L (``torch.utils.checkpoint``
      around every layer).
    * ``lora_rank`` > 0: the adapters of ``esm2.lora_init`` are the
      trainable tree over a frozen base, merged inside the loss;
      checkpoints hold the adapters (``<ckpt_path>_lora_<step>.npz``), and
      the merged model is returned.
    * ``resume``: restores the trainable tree and the step; the optimizer
      state starts afresh (schedule at count 0), as in the JAX package.
    * ``mesh``: a ``parallel.mesh.make_mesh`` mesh whose dp axis splits the
      batch (data parallelism, one process per device). Every rank draws
      the whole batch from the same ``draws`` and keeps its rows; the loss
      keeps the whole batch's normalisation (its sum of weighted
      cross-entropies over the whole batch's count of selected positions,
      the count summed over dp without a gradient), and the gradients are
      summed over dp before the optimizer's clip. Not DDP, which averages
      over ranks. batch_size must be a multiple of dp; rank 0 writes the
      checkpoints.

    Returns float32 master parameters (detached).
    """
    device = utils.resolve_device(device)
    toks = _esm_tokens(seqs)
    heads = esm2.CONFIGS[name]["heads"]
    if remat is None:
        remat = name == "transformer-L"
    if params is None:
        params = esm2.init(torch.Generator(device=device).manual_seed(seed),
                           name, torch.float32)
    params = _master_f32(params, device)
    train = (esm2.lora_init(
        torch.Generator(device=device).manual_seed(seed + 7), name,
        lora_rank) if lora_rank else params)
    start = 0
    if resume:
        train, start = load_ckpt(resume, train)
        if not lora_rank:
            params = train
    leaves = _trainable(train)
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(n_iters, warmup + 1), end_value=0.1 * lr)
    opt = Adam(leaves, sched, weight_decay=weight_decay,
               decay_mask=[a.dim() >= 2 for a in leaves], clip_norm=1.0)

    data = torch.from_numpy(toks).to(device, torch.long)
    weights = _row_weights(seq_weights, toks.shape[0], device, "sequences")
    draws = _draws(draws, device, seed + 3)
    dp = pmesh.axis(mesh, "dp") if mesh is not None else None
    n_dp, r_dp = (dp.size, dp.rank) if dp is not None else (1, 0)
    if batch_size % n_dp:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"dp={n_dp}")
    rows = slice(r_dp * (batch_size // n_dp),
                 (r_dp + 1) * (batch_size // n_dp))

    def one_step():
        tok = data[draws.rows(weights, batch_size)]               # [B, T]
        corrupt, is_sel = _esm_corrupt(draws, tok, mask_prob)
        full = esm2.lora_merge(params, train, lora_alpha) if lora_rank \
            else train
        # the rank's rows over the whole batch's count (sums over dp are
        # identities without a mesh)
        num, den = _mlm_sums(full, tok[rows], corrupt[rows], is_sel[rows],
                             heads, compute_dtype, remat)
        den = pmesh.all_sum(den.detach(), dp).clamp_min(1.0)
        opt.step(pmesh.all_sum_list(torch.autograd.grad(num / den, leaves),
                                    dp))
        return pmesh.all_sum(num.detach(), dp) / den

    ck_tag = "_lora_" if lora_rank else "_ckpt_"
    for done, size in _chunked(n_iters - start, chunk, log_every,
                               ckpt_every, start=start):
        losses = torch.stack([one_step() for _ in range(size)])
        step = start + done + size
        if not quiet and _log_due(step, log_every, n_iters):
            loss = float(losses.mean())
            print(f"[esm_mlm] iter {step} ce {loss:.4f} "
                  f"ppl {math.exp(loss):.2f}", flush=True)
        if ckpt_path and _log_due(step, ckpt_every, n_iters) \
                and pmesh.is_lead():
            save_ckpt(f"{ckpt_path}{ck_tag}{step}.npz", train, step)
    train = _detached(train)
    if lora_rank:
        with torch.no_grad():
            return esm2.lora_merge(params, train, lora_alpha)
    return train


# ---------------------------------------------------------------------------
# MSA-Transformer masked-LM training (family-specific evolutionary-density
# scorers)
# ---------------------------------------------------------------------------

def _msa_corrupt(draws, tok: torch.Tensor, mask_prob: float):
    """``_esm_corrupt`` over an MSA block [.., R, C+1]; column 0 (<cls>) is
    never selected. -> (corrupted, selected mask)."""
    corrupt, is_sel = _esm_corrupt(draws, tok, mask_prob)
    keep_cls = torch.arange(tok.shape[-1], device=tok.device) == 0
    return torch.where(keep_cls, tok, corrupt), is_sel & ~keep_cls


@torch.no_grad()
def msa_mlm_heldout_ce(params, msa_rows, name: str = "msa-S",
                       block_rows: int = 16, mask_prob: float = 0.15,
                       seed: int = 0, n_repeats: int = 4,
                       compute_dtype=torch.bfloat16, draws=None) -> float:
    """Masked-LM cross-entropy of an MSA-Transformer on held-out alignment
    rows: ``n_repeats`` blocks of ``block_rows`` rows, each drawn
    ``randint(n_rows, [R])`` and then corrupted (``_msa_corrupt``), masks
    from ``seed``; on the device of ``params``."""
    from ppde_tpu_torch.models import msa_transformer as msat

    device = params["embed"].device
    toks = torch.from_numpy(msat.tokenize_msa(list(msa_rows))).to(
        device, torch.long)
    heads = msat.heads_of(name)
    cparams = msat.cast_params(params, compute_dtype)
    R = min(block_rows, toks.shape[0])
    draws = _draws(draws, device, seed)
    num = torch.zeros((), device=device)
    den = torch.zeros((), device=device)
    for _ in range(n_repeats):
        block = toks[draws.randint(toks.shape[0], (R,))]        # [R, C+1]
        corrupt, is_sel = _msa_corrupt(draws, block, mask_prob)
        n, d = _masked_ce_sums(
            msat.forward_logits(cparams, corrupt[None], heads)[0], block,
            is_sel)
        num, den = num + n, den + d
    return float(num / den.clamp_min(1.0))


def train_msa_mlm(msa_rows, name: str = "msa-S", params=None,
                  n_iters: int = 2000, block_rows: int = 16,
                  lr: float = 3e-4, warmup: int = 100,
                  weight_decay: float = 0.01, mask_prob: float = 0.15,
                  seed: int = 0, log_every: int = 100,
                  ckpt_path: str | None = None, ckpt_every: int = 1000,
                  resume: str | None = None, quiet: bool = False,
                  chunk: int = 25, compute_dtype=torch.bfloat16,
                  seq_weights=None, device="cuda", draws=None):
    """Train an MSA-Transformer (``models/msa_transformer.py``) on a family
    alignment with the masked-LM objective, one [block_rows, C+1] block a
    step: ``rows(weights, R)`` (rows ~ ``seq_weights``, uniform when None),
    then ``_msa_corrupt``'s draws. The optimizer, precision, checkpoints
    and ``resume`` are ``train_esm_mlm``'s. Returns float32 master
    parameters."""
    from ppde_tpu_torch.models import msa_transformer as msat

    device = utils.resolve_device(device)
    toks = msat.tokenize_msa(list(msa_rows))
    heads = msat.heads_of(name)
    if params is None:
        params = msat.init(torch.Generator(device=device).manual_seed(seed),
                           torch.float32, name=name)
    params = _master_f32(params, device)
    start = 0
    if resume:
        params, start = load_ckpt(resume, params)
    leaves = _trainable(params)
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(n_iters, warmup + 1), end_value=0.1 * lr)
    opt = Adam(leaves, sched, weight_decay=weight_decay,
               decay_mask=[a.dim() >= 2 for a in leaves], clip_norm=1.0)

    data = torch.from_numpy(toks).to(device, torch.long)
    weights = _row_weights(seq_weights, toks.shape[0], device,
                           "alignment rows")
    R = min(block_rows, toks.shape[0])
    draws = _draws(draws, device, seed + 3)

    def one_step():
        block = data[draws.rows(weights, R)]                    # [R, C+1]
        corrupt, is_sel = _msa_corrupt(draws, block, mask_prob)
        logits = msat.forward_logits(msat.cast_params(params, compute_dtype),
                                     corrupt[None], heads)[0]
        num, den = _masked_ce_sums(logits, block, is_sel)
        loss = num / den.clamp_min(1.0)
        opt.step(torch.autograd.grad(loss, leaves))
        return loss.detach()

    for done, size in _chunked(n_iters - start, chunk, log_every,
                               ckpt_every, start=start):
        losses = torch.stack([one_step() for _ in range(size)])
        step = start + done + size
        if not quiet and _log_due(step, log_every, n_iters):
            loss = float(losses.mean())
            print(f"[msa_mlm] iter {step} ce {loss:.4f} "
                  f"ppl {math.exp(loss):.2f}", flush=True)
        if ckpt_path and _log_due(step, ckpt_every, n_iters):
            save_ckpt(f"{ckpt_path}_ckpt_{step}.npz", params, step)
    return _detached(params)


# ---------------------------------------------------------------------------
# EBM (persistent contrastive divergence with GWG sampling)
# ---------------------------------------------------------------------------

def _flip_logits(log_prob_fn, params, x: torch.Tensor):
    """(log p(x) [B], the GWG proposal logits [B, D]: d log p / dx times
    -(2x - 1) / 2)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        lp = log_prob_fn(params, x)
        g, = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g * -(2.0 * x.detach() - 1.0) / 2.0


def gwg_flip_step(params, x: torch.Tensor, draws, log_prob_fn=None):
    """One Gibbs-with-gradients bit-flip Metropolis-Hastings step on binary
    states [B, D] (Grathwohl et al.). Draws ``gumbel([B, D])`` (the
    categorical proposal, Gumbel-max as ``jax.random.categorical``) and
    ``uniform([B])`` (acceptance)."""
    if log_prob_fn is None:
        log_prob_fn = mnist_nets.ebm_log_prob
    e_x, logits = _flip_logits(log_prob_fn, params, x)
    idx = (draws.gumbel(logits.shape) + logits).argmax(-1)
    flip = F.one_hot(idx, x.shape[-1]).to(x.dtype)
    y = (1 - x) * flip + x * (1 - flip)
    e_y, rev_logits = _flip_logits(log_prob_fn, params, y)
    rows = torch.arange(x.shape[0], device=x.device)
    fwd = torch.log_softmax(logits, -1)[rows, idx]
    rev = torch.log_softmax(rev_logits, -1)[rows, idx]
    acc = torch.exp(e_y - e_x + rev - fwd) > draws.uniform((x.shape[0],))
    return torch.where(acc[:, None], y, x)


def train_ebm(images: np.ndarray, n_channels: int = 64, n_iters: int = 10000,
              batch_size: int = 100, buffer_size: int = 1000,
              sampling_steps: int = 20, lr: float = 1e-4,
              p_control: float = 1e-2, seed: int = 0, log_every: int = 200,
              ckpt_path: str | None = None, ckpt_every: int = 2000,
              quiet: bool = False, chunk: int = 50,
              reinit_p: float = 0.05, data_noise_p: float = 0.01,
              device="cuda", draws=None):
    """Persistent contrastive divergence: maximise E[log p(data)] -
    E[log p(buffer)] plus ``p_control`` times the squared energy-net
    outputs, with GWG chain updates of an on-device replay buffer (numpy
    Bernoulli(mean) start from ``seed``); clip_by_global_norm(1.0) then
    Adam. Every leaf trains, the Bernoulli ``mean`` too, as in the JAX
    package.

    A step draws, in order: ``randint(N, [B])`` (data rows),
    ``uniform([B, 784])`` (their binarisation), ``uniform([B, 784])`` (the
    data noise, when ``data_noise_p`` > 0), ``randint(buffer_size, [B])``
    (buffer rows), ``uniform([B, 1])`` (which chains restart),
    ``uniform([B, 784])`` (their fresh states), then ``sampling_steps``
    ``gwg_flip_step``s."""
    device = utils.resolve_device(device)
    mean = images.mean(0).clip(1e-2, 1 - 1e-2)
    params = mnist_nets.ebm_init(
        torch.Generator(device=device).manual_seed(seed), n_channels,
        mean=mean)
    leaves = _trainable(params)
    opt = Adam(leaves, lambda _: lr, clip_norm=1.0)

    data = torch.as_tensor(images, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    buffer = torch.from_numpy(
        (rng.random((buffer_size, images.shape[1]))
         < np.asarray(mean)[None]).astype(np.float32)).to(device)
    mean_t = torch.as_tensor(np.asarray(mean), dtype=torch.float32,
                             device=device)
    draws = _draws(draws, device, seed + 7)
    B, D = batch_size, data.shape[1]

    def one_step():
        sel = draws.randint(data.shape[0], (B,))
        x_data = (draws.uniform((B, D)) < data[sel]).float()
        if data_noise_p > 0:
            flip = (draws.uniform((B, D)) < data_noise_p).float()
            x_data = x_data * (1 - flip) + (1 - x_data) * flip
        bsel = draws.randint(buffer.shape[0], (B,))
        x0 = buffer[bsel]
        re = draws.uniform((B, 1)) < reinit_p
        fresh = (draws.uniform((B, D)) < mean_t[None]).float()
        x_model = torch.where(re, fresh, x0)
        frozen = _detached(params)
        for _ in range(sampling_steps):
            x_model = gwg_flip_step(frozen, x_model, draws)
        lp_data = mnist_nets.ebm_log_prob(params, x_data).mean()
        lp_model = mnist_nets.ebm_log_prob(params, x_model).mean()
        reg = p_control * (
            (mnist_nets.ebm_net_apply(params, x_data) ** 2).mean()
            + (mnist_nets.ebm_net_apply(params, x_model) ** 2).mean())
        loss = -(lp_data - lp_model) + reg
        opt.step(torch.autograd.grad(loss, leaves))
        buffer[bsel] = x_model
        return torch.stack([loss.detach(), lp_data.detach(),
                            lp_model.detach()])

    for done, size in _chunked(n_iters, chunk, log_every, ckpt_every):
        stats = torch.stack([one_step() for _ in range(size)])
        step = done + size
        if not quiet and _log_due(step, log_every, n_iters):
            loss, lpd, lpm = stats.mean(0).tolist()
            print(f"[ebm] iter {step} obj {loss:.3f} logp_data {lpd:.1f} "
                  f"logp_model {lpm:.1f}", flush=True)
        if ckpt_path and _log_due(step, ckpt_every, n_iters):
            save_ckpt(f"{ckpt_path}_ckpt_{step}.npz",
                      convert.mnist_to_numpy(params), step)
    return _detached(params)
