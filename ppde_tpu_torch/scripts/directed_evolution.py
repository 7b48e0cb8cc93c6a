"""Protein directed-evolution experiment CLI of the port.

    python -m ppde_tpu_torch.scripts.directed_evolution --protein ... \
        [--device cpu]

Counterpart of ``scripts/directed_evolution.py``: the same flags and
defaults, the same run-directory naming ({sampler}[_{signature}]_{seed}_
{timestamp}), the same printed lines and the same artifacts (config.txt, 7
.npy files, summary.json). Differences by design:

  * ``--device`` defaults to ``cuda`` and is honoured: without a GPU the
    run raises unless ``--device cpu`` is given (no silent CPU run);
  * ``--fused_cnn`` is accepted and does nothing: on CUDA the kernels
    always run;
  * the ``--mesh_*`` flags run one process per device, started by a
    launcher (``torchrun --nproc_per_node N -m
    ppde_tpu_torch.scripts.directed_evolution ... --mesh_dp N``; without
    one they raise), the backend following ``--device`` (nccl on CUDA,
    gloo on the CPU). The energy is sharded (``runtime.apply_mesh``) and
    the sampler runs replicated on every rank; rank 0 alone prints, writes
    the checkpoints and runs the rest of ``main`` (oracle, scores,
    artifacts, MSA-Transformer scoring) on the gathered population;
  * a ``--checkpoint_dir`` written by the JAX CLI is refused (a PRNG key
    where the port keeps a ``torch.Generator`` state); the port resumes
    from its own.

``--seed`` seeds ``np.random`` and the sampler's ``torch.Generator`` on the
device (CMA-ES: its numpy ask/tell).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
from pathlib import Path

import numpy as np
import torch

from ppde_tpu_torch import metrics, runtime, utils
from ppde_tpu_torch.models import potts as potts_mod
from ppde_tpu_torch.parallel import mesh as pmesh
from ppde_tpu_torch.samplers.protein import (cmaes, mala_approx, ppde, pt,
                                             random_search, sa)

SAMPLERS = ("PPDE", "PPDE-PT", "simulated_annealing", "Random",
            "MALA-approx", "CMAES")


def check_sampler(args) -> None:
    if args.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {args.sampler}")


def uses_mesh(args) -> bool:
    """Whether the run asks for a device mesh (the JAX CLI's test)."""
    return bool(args.mesh_dp or args.mesh_tp > 1 or args.mesh_ep > 1
                or args.mesh_sp > 1)


def get_sampler_runner(args, device):
    """runner(**kw) -> SamplerResult for ``args.sampler``."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    ck = args.checkpoint_dir or None
    common = dict(generator=gen, device=device, checkpoint_dir=ck)
    if args.sampler == "PPDE":
        cfg = ppde.PPDEConfig(pas_length=args.ppde_pas_length,
                              nmut_threshold=args.nmut_threshold,
                              paper_results=args.paper_results,
                              reference_reverse=args.ppde_reference_reverse)
        return lambda **kw: ppde.run(cfg=cfg, **common, **kw)
    if args.sampler == "PPDE-PT":
        cfg = pt.PTConfig(pas_length=args.ppde_pas_length,
                          nmut_threshold=args.nmut_threshold,
                          reference_reverse=args.ppde_reference_reverse,
                          n_levels=args.pt_levels,
                          beta_min=args.pt_beta_min,
                          swap_every=args.pt_swap_every)
        return lambda **kw: pt.run(cfg=cfg, **common, **kw)
    if args.sampler == "simulated_annealing":
        cfg = sa.SAConfig(temp=args.simulated_annealing_temp,
                          muts_per_seq_param=args.muts_per_seq_param,
                          decay_rate=args.decay_rate,
                          nmut_threshold=args.nmut_threshold)
        return lambda **kw: sa.run(cfg=cfg, **common, **kw)
    if args.sampler == "Random":
        cfg = random_search.RandomConfig(
            muts_per_seq_param=args.muts_per_seq_param)
        return lambda **kw: random_search.run(cfg=cfg, **common, **kw)
    if args.sampler == "MALA-approx":
        cfg = mala_approx.MALAConfig(
            step_size=args.diffusion_step_size,
            relaxation_tau=args.diffusion_relaxation_tau)
        return lambda **kw: mala_approx.run(cfg=cfg, **common, **kw)
    cfg = cmaes.CMAESConfig(
        population_size=args.cmaes_population_size,
        initial_variance=args.cmaes_initial_variance,
        diag={"auto": None, "full": False, "sep": True}[args.cmaes_cov])
    return lambda **kw: cmaes.run(cfg=cfg, seed=args.seed, device=device,
                                  checkpoint_dir=ck, **kw)


def main(args):
    check_sampler(args)
    unknown = runtime.expert_terms(args.unsupervised_expert)["unknown"]
    if unknown:
        raise ValueError(
            f"--unsupervised_expert {args.unsupervised_expert!r}: unknown "
            f"term(s) {unknown}; the terms are potts, an ESM2 config "
            f"(transformer-S/M/L) and an MSA Transformer config (msa-1b, "
            f"msa-S, msa-tiny)")
    device = args.device
    if uses_mesh(args):
        device = pmesh.init_distributed(device)
    device = utils.resolve_device(device)
    lead = pmesh.is_lead()
    np.random.seed(args.seed)

    unique = (f"{args.sampler}_{args.seed}"
              if args.run_signature == "" else
              f"{args.sampler}_{args.run_signature}_{args.seed}")
    unique += "_" + datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    results_path = Path(args.results_path, args.protein, unique)
    if lead:
        results_path.mkdir(parents=True, exist_ok=True)

    energy, oracle, pp, _ = runtime.build_protein_energy(args, device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    pop = runtime.make_initial_protein_population(protein_dir, args.n_chains,
                                                  device)

    with torch.no_grad():
        e0, _ = energy.energy(energy.params, pop)
    if lead:
        print(f"WT protein energy: {float(e0.mean()):.3f}", flush=True)

    if uses_mesh(args):
        mesh, energy, pop = runtime.apply_mesh(
            energy, pop, dp=args.mesh_dp or None, tp=args.mesh_tp,
            ep=args.mesh_ep, sp=args.mesh_sp)
        if lead:
            print(f"mesh: {pmesh.mesh_shape(mesh)}", flush=True)
    res = get_sampler_runner(args, device)(
        energy=energy, initial_population=pop, num_steps=args.n_iters,
        min_pos=pp.min_pos, max_pos=pp.max_pos, oracle=oracle,
        log_every=args.log_every, quiet=not lead)
    if not lead:
        return None

    with torch.no_grad():
        best = torch.from_numpy(res.best_x).to(device)
        best_oracle = oracle[1](oracle[0], best).cpu().numpy()
        potts_score = potts_mod.score(pp, best, delta=True).cpu().numpy()

    qs = [0.2, 0.4, 0.6, 0.8, 1.0]
    print(f"energy quantiles: {np.quantile(res.best_energy, qs)}")
    print(f"fitness quantiles: {np.quantile(res.best_fitness, qs)}")
    print(f"oracle quantiles: {np.quantile(best_oracle, qs)}")
    print(f"potts quantiles: {np.quantile(potts_score, qs)}")
    print(f"sampler throughput: {res.steps_per_sec:.1f} steps/s "
          f"({res.steps_per_sec * args.n_chains:.0f} chain-steps/s)")

    runtime.dump_config(args, results_path / "config.txt")
    np.save(results_path / "population.npy", res.best_x)
    np.save(results_path / "pred_fitness_scores.npy", res.best_fitness)
    np.save(results_path / "oracle_fitness_scores.npy", best_oracle)
    np.save(results_path / "potts_scores.npy", potts_score)
    np.save(results_path / "energy_scores.npy", res.best_energy)
    np.save(results_path / "energy_history.npy", res.energy_history)
    np.save(results_path / "fitness_history.npy", res.fitness_history)

    tscore = None
    if not args.disable_MSA_transformer_scoring:
        try:
            tscore = metrics.proteins_transformer_score(
                np.asarray(res.best_x), protein_dir, args.msa_path,
                args.msa_size, weights_path=args.msa_transformer_weights,
                msa_model=args.msa_transformer_model, device=device)
            print(f"MSATransformer quantiles: {np.quantile(tscore, qs)}")
            np.save(results_path / "transformer_scores.npy", tscore)
        except FileNotFoundError as e:
            print(f"[skip] MSA-Transformer scoring unavailable: {e}",
                  flush=True)

    summary = runtime.cell_summary(
        args, results_path, population=res.best_x,
        wt_onehot=pop[:1].cpu().numpy(), oracle_scores=best_oracle,
        fitness=np.asarray(res.best_fitness),
        energy=np.asarray(res.best_energy), potts_scores=potts_score,
        transformer_scores=tscore, steps_per_sec=res.steps_per_sec,
        wall_steps_per_sec=res.wall_steps_per_sec,
        potts_provenance=runtime.potts_provenance(protein_dir,
                                                  args.potts_npz))
    with open(results_path / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    if args.summary_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary_json)),
                    exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=2)

    print("done")
    return results_path


def build_parser():
    p = argparse.ArgumentParser()
    g = p.add_argument_group("general")
    g.add_argument("--protein_weights", type=str, default="weights")
    g.add_argument("--results_path", type=str, default="results/proteins")
    g.add_argument("--protein", type=str, default="PABP_YEAST_Fields2013",
                   help="PABP_YEAST_Fields2013, "
                        "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio, "
                        "GFP_AEQVI_Sarkisyan2016")
    g.add_argument("--hub_dir", type=str, default=".")
    g.add_argument("--msa_path", type=str,
                   default="data/proteins/PABP_YEAST.a2m")
    g.add_argument("--msa_size", type=int, default=500)
    g.add_argument("--seed", type=int, default=1234567)
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu (the "
                        "kernels' plain versions)")
    g.add_argument("--log_every", type=int, default=50)
    g.add_argument("--run_signature", type=str, default="")
    g.add_argument("--n_iters", type=int, default=10000)
    g.add_argument("--n_chains", type=int, default=128)
    g.add_argument("--energy_lamda", type=float, default=5)
    g.add_argument("--energy_function", type=str, default="product_of_experts",
                   help="product_of_experts, supervised")
    g.add_argument("--unsupervised_expert", type=str, default="potts",
                   help="potts, transformer-S, transformer-M, transformer-L, "
                        "msa-1b, msa-S, msa-tiny, joined by '+' (e.g. "
                        "potts+transformer, potts+msa-1b); another term "
                        "raises")
    g.add_argument("--sampler", type=str, default="PPDE")
    g.add_argument("--nmut_threshold", type=int, default=0)
    g.add_argument("--disable_MSA_transformer_scoring", action="store_true")
    g.add_argument("--paper_results", action="store_true", default=False)
    g.add_argument("--esm_weights", type=str, default=None,
                   help="path to a fair-esm esm2_t*.pt checkpoint "
                        "(transformer experts)")
    g.add_argument("--potts_npz", type=str, default=None,
                   help="override the protein dir's Potts artifact with "
                        "this save_npz fit (expert energy AND the oracle's "
                        "evolutionary feature both use it — e.g. the "
                        "reference-scale-matched artifact from "
                        "scripts/calibrate_oracle_scale.py)")
    g.add_argument("--msa_transformer_weights", type=str, default=None,
                   help="path to a fair-esm esm_msa1b .pt checkpoint, or a "
                        "family-trained .npz (scripts/finetune_msa.py)")
    g.add_argument("--msa_transformer_model", type=str, default="msa-1b",
                   help="msa_transformer.CONFIGS key the weights belong to")
    g.add_argument("--allow_random_esm", "--allow_random_msa",
                   action="store_true",
                   help="use a randomly-initialized transformer expert "
                        "(ESM2 or the MSA Transformer; smoke tests only)")
    g.add_argument("--msa_expert_weights", type=str, default=None,
                   help="MSA Transformer expert (an msa-* term): a native "
                        ".npz of its config or a fair-esm esm_msa1b .pt")
    g.add_argument("--msa_expert_context", type=str, default=None,
                   help="a2m / FASTA of aligned rows of the wild type's "
                        "length: the MSA Transformer expert's context, its "
                        "first msa_expert_rows - 1 rows in file order")
    g.add_argument("--msa_expert_rows", type=int, default=32,
                   help="rows of the MSA Transformer expert's alignment: "
                        "the chain's and msa_expert_rows - 1 context rows")
    g.add_argument("--summary_json", type=str, default="",
                   help="also write the machine-readable cell summary to "
                        "this stable path (a summary.json is always written "
                        "into the timestamped run dir); PARITY.md's tables "
                        "cite these")
    g.add_argument("--checkpoint_dir", type=str, default="",
                   help="persist sampler state here and auto-resume "
                        "(capability absent from the reference)")
    g.add_argument("--fused_cnn", action="store_true",
                   help="accepted and ignored: on CUDA the CNN ensemble "
                        "always runs its fused kernel")
    g.add_argument("--cnn_chunk", type=int, default=0,
                   help="chunk the CNN energy over this many chains "
                        "(0 = auto: 128 when n_chains > 256)")
    g.add_argument("--pool_bwd", choices=["split", "first"],
                   default="split",
                   help="max-pool backward: equal split on ties (default) "
                        "or torch.max first-argmax routing (reference "
                        "gradient parity)")
    g.add_argument("--esm_chunk", "--msa_expert_chunk", type=int, default=0,
                   help="chunk the transformer energy over this many chains "
                        "(0 = auto: one piece where the one-piece gradient's "
                        "measured peak memory fits in 80%% of the card, else "
                        "the largest chunk that fits, runtime."
                        "resolve_esm_chunk, or for the MSA Transformer "
                        "runtime.resolve_msa_grad; -1 = one piece)")
    g.add_argument("--mesh_dp", type=int, default=0,
                   help="shard chains over a dp-axis device mesh of this "
                        "size (0 = single device); chains must divide it")
    g.add_argument("--mesh_tp", type=int, default=1,
                   help="shard the Potts coupling matmul over a tp axis")
    g.add_argument("--mesh_ep", type=int, default=1,
                   help="shard stacked supervised-ensemble members over an "
                        "ep axis (member count must divide it; the default "
                        "3-member ensembles replicate unless ep is 3)")
    g.add_argument("--mesh_sp", type=int, default=1,
                   help="sequence parallelism for transformer experts: "
                        "shard the ESM2 residual stream's T axis over an "
                        "sp axis (activation memory / LN+FFN compute per "
                        "device drop by sp)")
    g.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32",
                   help="supervised-CNN compute precision")

    sa_g = p.add_argument_group("simulated_annealing")
    sa_g.add_argument("--simulated_annealing_temp", type=float, default=0.01)
    sa_g.add_argument("--muts_per_seq_param", type=float, default=1.5)
    sa_g.add_argument("--decay_rate", type=float, default=0.999)

    d = p.add_argument_group("mala_approx")
    d.add_argument("--diffusion_step_size", type=float, default=0.1)
    d.add_argument("--diffusion_relaxation_tau", type=float, default=0.99)

    c = p.add_argument_group("cmaes")
    c.add_argument("--cmaes_population_size", type=int, default=16)
    c.add_argument("--cmaes_initial_variance", type=float, default=0.05)
    c.add_argument("--cmaes_cov", choices=["auto", "full", "sep"],
                   default="auto",
                   help="covariance model: full CMA-ES, sep-CMA (diagonal, "
                        "O(d)/gen — needed at GFP's d=4760), or auto by "
                        "dimension")

    pp = p.add_argument_group("ppde")
    pp.add_argument("--ppde_pas_length", type=int, default=2)
    pp.add_argument("--pt_levels", type=int, default=8,
                    help="PPDE-PT: temperature levels (n_chains %% levels "
                         "== 0; beyond-reference parallel tempering, "
                         "samplers/protein/pt.py)")
    pp.add_argument("--pt_beta_min", type=float, default=0.25,
                    help="PPDE-PT: hottest inverse temperature (geometric "
                         "ladder down from 1.0)")
    pp.add_argument("--pt_swap_every", type=int, default=1,
                    help="PPDE-PT: attempt replica exchanges every this "
                         "many steps")
    pp.add_argument("--ppde_reference_reverse", action="store_true",
                    help="reproduce the reference's reverse-path estimator "
                         "(evaluates reverse log-probs at the FORWARD "
                         "indices — not a valid MH involution; biases the "
                         "chain hot. Default is the corrected reverse; see "
                         "PPDEConfig.reference_reverse)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
