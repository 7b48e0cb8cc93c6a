"""Multi-host sweep driver: the experiment grid partitioned over hosts.

    python -m ppde_tpu_torch.scripts.sweep_dcn --dry_run
    srun python -m ppde_tpu_torch.scripts.sweep_dcn   (ids from SLURM)

Counterpart of ``scripts/sweep_dcn.py``, with its grid, names and flags.
The reference's experiment grid (protein x expert x sampler x seed;
reference scripts/run_protein_samplers.sh) is embarrassingly parallel:
each cell is an independent run on one device, so hosts split the grid
rather than one run. This driver:

  * enumerates the full canonical grid deterministically (stable ordering,
    so every host computes the identical list);
  * partitions it round-robin by (host_id, num_hosts), from the flags or
    the launcher's environment (JAX_PROCESS_ID / JAX_NUM_PROCESSES,
    SLURM_PROCID / SLURM_NTASKS, TPU_WORKER_ID / TPU_WORKER_COUNT, the
    variables the JAX package's driver reads);
  * runs each assigned cell as a subprocess of ``python -m
    ppde_tpu_torch.scripts.directed_evolution`` with its own checkpoint
    directory, so a preempted host resumes mid-run;
  * --dry_run prints the assignment without executing.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# calibrated lambdas per (protein, expert): README.md:65-72 / BASELINE.md
LAMBDA = {
    ("PABP_YEAST_Fields2013", "potts"): 5.0,
    ("UBE4B_MOUSE_Klevit2013-nscor_log2_ratio", "potts"): 0.5,
    ("GFP_AEQVI_Sarkisyan2016", "potts"): 15.0,
    ("PABP_YEAST_Fields2013", "transformer-M"): 5.0,
    ("UBE4B_MOUSE_Klevit2013-nscor_log2_ratio", "transformer-M"): 3.0,
    ("GFP_AEQVI_Sarkisyan2016", "transformer-M"): 1.0,
}
PROTEINS = sorted({p for p, _ in LAMBDA})
MCMC_BASELINES = ("simulated_annealing", "Random", "MALA-approx")


def discover_family(root, proteins, model="transformer-S"):
    """Find per-protein family-expert artifacts under ``root``
    (scripts/run_esm_family.sh's outputs): the highest-step fine-tuned
    expert `<prot>_<model>_ckpt_<N>.npz`, the highest-step msa-S density
    scorer `<prot>_msat_S_ckpt_<N>.npz` (optional), and the family MSA the
    expert was trained on (real a2m when the upstream blob exists,
    provenance-marked synthetic otherwise — scripts/sample_potts_msa.py).

    Returns {protein: {"ckpt", "scorer", "msa"}} for proteins whose expert
    checkpoint exists; deterministic (sorted) so every DCN host agrees.
    """
    import glob

    def latest(pattern):
        # step suffix must be a bare integer; tolerate stray files like
        # *_ckpt_final.npz or *_ckpt_4000_best.npz the glob also matches
        hits = []
        for p in glob.glob(pattern):
            tail = p.rsplit("_", 1)[-1][:-4]
            if tail.isdigit():
                hits.append((int(tail), p))
        return max(hits)[1] if hits else None

    fam = {}
    for prot in sorted(proteins):
        ckpt = latest(os.path.join(root, f"{prot}_{model}_ckpt_*.npz"))
        if not ckpt:
            continue
        short = prot.split("_")[0]
        scorer = (latest(os.path.join(root, f"{prot}_msat_S_ckpt_*.npz"))
                  or latest(os.path.join(root, f"{short}_msat_S_ckpt_*.npz")))
        real = sorted(glob.glob(
            os.path.join(REPO, "data", "proteins", f"{short}_*.a2m")))
        synth = os.path.join(REPO, "data", "proteins", "synthetic",
                             f"{prot}_synth.a2m")
        msa = next((m for m in real + [synth] if os.path.exists(m)), None)
        fam[prot] = {"ckpt": ckpt, "scorer": scorer, "msa": msa}
    return fam


def build_grid(seeds, n_iters, cmaes_iters, esm_weights=None,
               experts=("potts",), family=None, family_iters=2500,
               family_model="transformer-S"):
    """The canonical cells, in a deterministic order every host agrees on.

    Returns a list of dicts: {name, argv}: argv for the
    ``directed_evolution`` CLI.

    ``family`` ({protein: {"ckpt", "scorer", "msa"}}, see discover_family)
    appends the family-expert cells (PARITY.md "Family-trained ESM2
    expert"): PPDE with potts+<model> and with <model> alone at the
    published transformer lambda, evolutionary density scored by the
    per-protein msa-S scorer when one exists.
    """
    cells = []

    def add(name, *argv):
        cells.append({"name": name, "argv": [str(a) for a in argv]})

    for seed in seeds:
        for prot in PROTEINS:
            for expert in experts:
                if expert != "potts" and not esm_weights:
                    continue  # transformer cells need a checkpoint
                lam = LAMBDA[(prot, expert)]
                extra = ([] if expert == "potts"
                         else ["--esm_weights", esm_weights])
                sig = "potts" if expert == "potts" else "transformer"
                # PPDE twice: corrected reverse + the reference's estimator
                add(f"{prot}/{expert}/PPDE-exact/s{seed}",
                    "--protein", prot, "--sampler", "PPDE",
                    "--unsupervised_expert", expert, "--energy_lamda", lam,
                    "--n_iters", n_iters, "--seed", seed,
                    "--run_signature", f"{sig}_exact", *extra)
                add(f"{prot}/{expert}/PPDE-refrev/s{seed}",
                    "--protein", prot, "--sampler", "PPDE",
                    "--ppde_reference_reverse",
                    "--unsupervised_expert", expert, "--energy_lamda", lam,
                    "--n_iters", n_iters, "--seed", seed,
                    "--run_signature", sig, *extra)
                for sampler in MCMC_BASELINES:
                    add(f"{prot}/{expert}/{sampler}/s{seed}",
                        "--protein", prot, "--sampler", sampler,
                        "--unsupervised_expert", expert,
                        "--energy_lamda", lam, "--n_iters", n_iters,
                        "--seed", seed, "--run_signature", sig, *extra)
                add(f"{prot}/{expert}/CMAES/s{seed}",
                    "--protein", prot, "--sampler", "CMAES",
                    "--unsupervised_expert", expert, "--energy_lamda", lam,
                    "--n_iters", cmaes_iters, "--seed", seed,
                    "--run_signature", sig, *extra)
                # beyond-reference: parallel-tempering PPDE (corrected rev)
                add(f"{prot}/{expert}/PPDE-PT/s{seed}",
                    "--protein", prot, "--sampler", "PPDE-PT",
                    "--unsupervised_expert", expert, "--energy_lamda", lam,
                    "--n_iters", n_iters, "--seed", seed,
                    "--run_signature", f"{sig}_pt", *extra)
        for prot, art in sorted((family or {}).items()):
            lam = LAMBDA.get((prot, "transformer-M"), 1.0)  # published λ
            score = ([] if not (art.get("scorer") and art.get("msa")) else
                     ["--msa_transformer_model", "msa-S",
                      "--msa_transformer_weights", art["scorer"],
                      "--msa_path", art["msa"]])
            # run_signature uses '_' (not '+') so the evidence identity
            # matches run_r4_family_cells.sh and the committed
            # results/esm_family/*_family_*.json cells (render_parity_tables
            # groups seed spreads by run_signature)
            for expert, tag in ((f"potts+{family_model}",
                                 f"potts_{family_model}_family"),
                                (family_model, f"{family_model}_family")):
                add(f"{prot}/family/{expert}/s{seed}",
                    "--protein", prot, "--sampler", "PPDE",
                    "--unsupervised_expert", expert,
                    "--esm_weights", art["ckpt"], "--energy_lamda", lam,
                    "--n_iters", family_iters, "--seed", seed,
                    "--run_signature", tag, *score)
    return cells


def detect_host(args):
    """(host_id, num_hosts) from flags or standard launcher env."""
    if args.num_hosts is not None:
        return args.host_id or 0, args.num_hosts
    for id_var, n_var in (("JAX_PROCESS_ID", "JAX_NUM_PROCESSES"),
                          ("SLURM_PROCID", "SLURM_NTASKS"),
                          ("TPU_WORKER_ID", "TPU_WORKER_COUNT")):
        if id_var in os.environ and n_var in os.environ:
            return int(os.environ[id_var]), int(os.environ[n_var])
    return 0, 1


def partition(cells, host_id, num_hosts):
    """Round-robin: adjacent cells (often the same protein) land on
    different hosts, balancing the heavy PPDE cells across the fleet."""
    return [c for i, c in enumerate(cells) if i % num_hosts == host_id]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host_id", type=int, default=None)
    ap.add_argument("--num_hosts", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1234567])
    ap.add_argument("--n_iters", type=int, default=10000)
    ap.add_argument("--cmaes_iters", type=int, default=1000)
    ap.add_argument("--n_chains", type=int, default=128)
    ap.add_argument("--esm_weights", type=str, default="")
    ap.add_argument("--experts", type=str, nargs="+", default=["potts"])
    ap.add_argument("--family_root", type=str, default="results/esm_family",
                    help="directory holding run_esm_family.sh artifacts; "
                         "proteins with a fine-tuned expert checkpoint "
                         "there get family-expert cells (pass '' to skip)")
    ap.add_argument("--family_model", type=str, default="transformer-S")
    ap.add_argument("--family_iters", type=int, default=2500)
    ap.add_argument("--results_path", type=str, default="results/proteins")
    ap.add_argument("--checkpoint_root", type=str,
                    default="results/sweep_ckpts")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    host_id, num_hosts = detect_host(args)
    family = (discover_family(args.family_root, PROTEINS, args.family_model)
              if args.family_root else {})
    cells = build_grid(args.seeds, args.n_iters, args.cmaes_iters,
                       args.esm_weights or None, tuple(args.experts),
                       family=family, family_iters=args.family_iters,
                       family_model=args.family_model)
    mine = partition(cells, host_id, num_hosts)
    print(f"[sweep_dcn] host {host_id}/{num_hosts}: {len(mine)} of "
          f"{len(cells)} cells", flush=True)
    for c in mine:
        print(f"  {c['name']}", flush=True)
    if args.dry_run:
        return 0

    failures = []
    for c in mine:
        ck = os.path.join(args.checkpoint_root,
                          c["name"].replace("/", "_"))
        cmd = [sys.executable, "-m",
               "ppde_tpu_torch.scripts.directed_evolution",
               *c["argv"], "--n_chains", str(args.n_chains),
               "--nmut_threshold", "10",
               "--results_path", args.results_path,
               "--checkpoint_dir", ck]
        if "--msa_transformer_weights" not in c["argv"]:
            # no usable density scorer for this cell; skip the expensive
            # (and weight-blocked by default) msa1b scoring pass
            cmd.append("--disable_MSA_transformer_scoring")
        print(f"[sweep_dcn] running {c['name']}", flush=True)
        env = {**os.environ,
               "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", "")}
        r = subprocess.run(cmd, env=env)
        if r.returncode != 0:
            failures.append(c["name"])
            print(f"[sweep_dcn] FAILED: {c['name']} (exit {r.returncode})",
                  flush=True)
    if failures:
        print(f"[sweep_dcn] {len(failures)} cells failed: {failures}",
              flush=True)
        return 1
    print("[sweep_dcn] all cells done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
