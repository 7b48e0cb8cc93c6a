"""MNIST-sum experiment CLI of the port (maximise the sum of two digits).

    python -m ppde_tpu_torch.scripts.mnist_sum [--device cpu] ...

Counterpart of ``scripts/mnist_sum.py``: the same flags and defaults, the
same wild-type pairs (``WT_FILES``), printed lines and artifacts (the
``--metrics`` writers), and the same expert lookup: the supervised
ensemble and the oracle from the reference ``.pt`` state dicts; the EBM or
DAE from the reference ``.pt`` if present, else the newest ``*_ckpt_*.npz``
of the JAX package's trainer, the EBM's Bernoulli mean from
``data_dir/mnist_mean.npy`` clamped to [eps, 1 - eps], eps = 1e-2.
Differences by design:

  * ``--device`` defaults to ``cuda`` and is honoured: without a GPU the
    run raises unless ``--device cpu`` is given;
  * before it samples, the CLI checks that every writer ``--metrics`` asks
    for can import its package (matplotlib for plots and viz, PIL for the
    gif) and raises, naming the package and the flag, if one cannot; the
    CSVs need no package;
  * a ``--checkpoint_dir`` written by the JAX CLI is refused.

``scripts/seeded_mnist.py`` writes weights and data directories of seeded
stand-ins for the inputs that are not tracked.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import os
from pathlib import Path

import numpy as np
import torch

from ppde_tpu_torch import convert, energy as energy_mod, metrics, utils
from ppde_tpu_torch.models import mnist_nets, torch_convert
from ppde_tpu_torch.samplers.mnist import cmaes, mala_approx, ppde, pt, sa

WT_FILES = {
    0: ("3_0.npy", "3_1.npy"),
    1: ("29_0.npy", "29_1.npy"),
    2: ("38_0.npy", "38_1.npy"),
    3: ("99_0.npy", "99_1.npy"),
    4: ("149_0.npy", "149_1.npy"),
    -1: ("validation_0.npy", "validation_1.npy"),
}
MEAN_EPS = 1e-2


def check_writers(metrics_flag: str) -> None:
    """Raise before sampling if a writer ``--metrics`` asks for cannot
    import its package."""
    for writer in metrics_flag.split("+"):
        pkg = metrics.WRITER_PACKAGES.get(writer)
        if pkg is None:
            continue
        try:
            importlib.import_module(pkg)
        except ImportError as e:
            raise RuntimeError(
                f"--metrics {writer} needs the package {pkg}, which cannot "
                f"be imported ({e}); install it or drop '{writer}' from "
                f"--metrics {metrics_flag}") from e


def load_unsup(w: Path, torch_name: str, npz_glob: str, converter, init_like):
    """JAX-layout numpy parameters of the EBM or DAE: the reference .pt if
    present, else the newest trainer .npz."""
    pt_path = w / torch_name
    if pt_path.exists():
        return converter(str(pt_path))
    npzs = sorted(glob.glob(str(w / npz_glob)))
    if npzs:
        return mnist_nets.load_npz(npzs[-1], init_like)[0]
    raise FileNotFoundError(
        f"neither {pt_path} nor {w / npz_glob} exists; the reference repo's "
        "blob is missing, and no trainer checkpoint is there either")


def build_energy(args, device):
    w = Path(args.mnist_weights)
    ens = convert.mnist_regression_from_numpy(
        torch_convert.mnist_regression_ensemble(
            [str(w / f"ensemble_{i}_ckpt_25000.pt") for i in range(3)]),
        device)
    if args.energy_function == "supervised":
        return energy_mod.mnist_supervised(ens)
    gen = torch.Generator().manual_seed(0)
    if args.unsupervised_expert == "ebm":
        mean = np.load(os.path.join(args.data_dir, "mnist_mean.npy"))
        mean = mean.reshape(-1) * (1.0 - 2 * MEAN_EPS) + MEAN_EPS
        params = load_unsup(w, "mnist_ebm.pt", "mnist_ebm_ckpt_*.npz",
                            torch_convert.resnet_ebm,
                            mnist_nets.ebm_init(gen, 64, mean=mean))
        params["mean"] = mean.astype(np.float32)
        return energy_mod.mnist_poe(convert.ebm_from_numpy(params, device),
                                    ens, args.energy_lamda, "ebm")
    if args.unsupervised_expert == "dae":
        params = load_unsup(w, "mnist_binary_dae.pt",
                            "mnist_binary_dae_ckpt_*.npz", torch_convert.dae,
                            mnist_nets.dae_init(gen, 16, 64))
        return energy_mod.mnist_poe(convert.dae_from_numpy(params, device),
                                    ens, args.energy_lamda, "dae")
    raise ValueError(args.unsupervised_expert)


def get_sampler_runner(args, device):
    """(runner(**kw) -> SamplerResult, the run's abbreviation)."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    ck = args.checkpoint_dir or None
    common = dict(generator=gen, device=device, checkpoint_dir=ck)
    if args.sampler == "PPDE":
        abbrv = (f"PPDE-PAS-{args.ppde_pas_length}" if args.ppde_pas_length > 0
                 else f"PPDE-GWG-{args.ppde_gwg_samples}")
        cfg = ppde.MNISTPPDEConfig(pas_length=args.ppde_pas_length,
                                   gwg_samples=args.ppde_gwg_samples)
        return (lambda **kw: ppde.run(cfg=cfg, **common, **kw)), abbrv
    if args.sampler == "PPDE-PT":
        cfg = pt.MNISTPTConfig(pas_length=args.ppde_pas_length,
                               gwg_samples=args.ppde_gwg_samples,
                               n_levels=args.pt_levels,
                               beta_min=args.pt_beta_min,
                               swap_every=args.pt_swap_every)
        return (lambda **kw: pt.run(cfg=cfg, **common, **kw)), "PPDE-PT"
    if args.sampler == "simulated_annealing":
        cfg = sa.MNISTSAConfig(temp=args.simulated_annealing_temp,
                               muts_per_seq_param=args.muts_per_seq_param,
                               decay_rate=args.decay_rate)
        return (lambda **kw: sa.run(cfg=cfg, **common, **kw)), "SA"
    if args.sampler == "MALA-approx":
        cfg = mala_approx.MNISTMALAConfig(
            step_size=args.diffusion_step_size,
            relaxation_tau=args.diffusion_relaxation_tau)
        return (lambda **kw: mala_approx.run(cfg=cfg, **common, **kw)), \
            "MALA-approx"
    if args.sampler == "CMAES":
        cfg = cmaes.MNISTCMAESConfig(
            population_size=args.cmaes_population_size,
            initial_variance=args.cmaes_initial_variance)
        return (lambda **kw: cmaes.run(cfg=cfg, seed=args.seed, device=device,
                                       checkpoint_dir=ck, **kw)), "CMAES"
    raise ValueError(args.sampler)


def main(args):
    check_writers(args.metrics)
    device = utils.resolve_device(args.device)
    np.random.seed(args.seed)
    Path(args.results_path).mkdir(parents=True, exist_ok=True)

    energy = build_energy(args, device)
    oracle_params = convert.mnist_regression_from_numpy(
        torch_convert.mnist_regression(
            str(Path(args.mnist_weights) / "one-hot_GT_ckpt_60000.pt")),
        device)
    oracle = (oracle_params,
              lambda p, x2, x1: mnist_nets.regression_apply(p, x1, x2))

    fa, fb = WT_FILES[args.wild_type]
    a = np.load(os.path.join(args.data_dir, fa)).reshape(784)
    b = np.load(os.path.join(args.data_dir, fb)).reshape(784)
    pop = np.concatenate([np.tile(a, (args.n_chains, 1)),
                          np.tile(b, (args.n_chains, 1))], 1).astype(np.float32)

    runner, abbrv = get_sampler_runner(args, device)
    abbrv += f"_{args.energy_function}"
    if args.suffix:
        abbrv += f"_{args.suffix}"

    res = runner(energy=energy, initial_population=pop,
                 num_steps=args.n_iters, oracle=oracle,
                 log_every=args.log_every)
    print(f"sampler throughput: {res.steps_per_sec:.1f} steps/s", flush=True)

    m = args.metrics.split("+")
    # histories are thinned to the oracle's cadence for plots and CSVs: the
    # MCMC samplers record fitness every step (row s == step s, fit0
    # first), the oracle at segment boundaries [0, log_every, ..., n_iters]
    # (a ragged tail segment ends at n_iters); CMA-ES records both at the
    # log cadence already
    orc_hist = res.oracle_history
    if len(res.fitness_history) > len(orc_hist) >= 1:
        steps = np.minimum(np.arange(len(orc_hist)) * args.log_every,
                           len(res.fitness_history) - 1)
        fit_hist = res.fitness_history[steps]
    else:
        fit_hist = res.fitness_history
    n = min(len(fit_hist), len(orc_hist))
    if "plots" in m and n > 0:
        metrics.mnist_performance_plots(fit_hist[:n], orc_hist[:n], abbrv,
                                        args)
    if "viz" in m:
        metrics.visualize_population(res.final_x, abbrv, args)
    if "csv" in m and n > 0:
        metrics.mnist_scores_to_csv(fit_hist[:n], orc_hist[:n], abbrv, args)
    if "gif" in m and res.random_traj is not None:
        stride_gif = max(1, len(res.random_traj) // args.gif_frames)
        metrics.make_gif(res.random_traj[::stride_gif], abbrv, args)
    print("done")
    return res


def build_parser():
    p = argparse.ArgumentParser()
    g = p.add_argument_group("general")
    g.add_argument("--mnist_weights", type=str, default="weights/mnist_models")
    g.add_argument("--data_dir", type=str, default="data/mnist")
    g.add_argument("--results_path", type=str, default="results/mnist")
    g.add_argument("--wild_type", type=int, default=0)
    g.add_argument("--seed", type=int, default=1234567)
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    g.add_argument("--n_iters", type=int, default=200)
    g.add_argument("--n_chains", type=int, default=128)
    g.add_argument("--energy_lamda", type=float, default=10)
    g.add_argument("--energy_function", type=str, default="product_of_experts")
    g.add_argument("--unsupervised_expert", type=str, default="ebm")
    g.add_argument("--log_every", type=int, default=50)
    g.add_argument("--sampler", type=str, default="simulated_annealing")
    g.add_argument("--suffix", type=str, default="")
    g.add_argument("--checkpoint_dir", type=str, default="",
                   help="persist sampler state here and auto-resume "
                        "(capability absent from the reference)")
    g.add_argument("--metrics", type=str, default="gif+plots+viz+csv")
    g.add_argument("--gif_frames", type=int, default=200)

    sa_g = p.add_argument_group("simulated_annealing")
    sa_g.add_argument("--simulated_annealing_temp", type=float, default=10)
    sa_g.add_argument("--muts_per_seq_param", type=float, default=5)
    sa_g.add_argument("--decay_rate", type=float, default=0.999)

    d = p.add_argument_group("mala_approx")
    d.add_argument("--diffusion_step_size", type=float, default=0.01)
    d.add_argument("--diffusion_relaxation_tau", type=float, default=0.9)

    c = p.add_argument_group("cmaes")
    c.add_argument("--cmaes_population_size", type=int, default=16)
    c.add_argument("--cmaes_initial_variance", type=float, default=0.1)

    pp = p.add_argument_group("ppde")
    pp.add_argument("--ppde_gwg_samples", type=int, default=1)
    pp.add_argument("--ppde_pas_length", type=int, default=10)
    pp.add_argument("--pt_levels", type=int, default=8,
                    help="PPDE-PT: temperature levels (n_chains %% levels "
                         "== 0; beyond-reference parallel tempering, "
                         "samplers/mnist/pt.py)")
    pp.add_argument("--pt_beta_min", type=float, default=0.25,
                    help="PPDE-PT: hottest inverse temperature (geometric "
                         "ladder down from 1.0)")
    pp.add_argument("--pt_swap_every", type=int, default=1,
                    help="PPDE-PT: attempt replica exchanges every this "
                         "many steps")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
