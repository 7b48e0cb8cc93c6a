"""Run assembly: build energies, oracles and initial populations.

Counterpart of ``ppde_tpu/runtime.py`` (the protein parts): the glue the
reference keeps in its entry script (scripts/directed_evolution.py:21-81),
factored into a library so the CLI, tests and chip_smoke.py construct
identical runs. Every function that makes tensors takes a ``device``. The
JAX package's ``enable_compile_cache`` has no counterpart.
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from ppde_tpu_torch import codec, convert, energy as energy_mod, io as pio
from ppde_tpu_torch import metrics, utils
from ppde_tpu_torch.models import oracle as oracle_mod, potts as potts_mod
from ppde_tpu_torch.models import torch_convert


def load_potts(protein_dir: str, allow_synthetic: bool = True,
               dtype=torch.float32, device="cuda") -> potts_mod.PottsParams:
    """Load Potts params: potts.pkl (reference artifact) > potts.npz (the
    JAX package's fitter's artifact) > deterministic synthetic fallback.

    The reference's potts.pkl blobs are missing from its repo; the JAX
    package's ``scripts/fit_potts.py`` makes npz params from an MSA.
    """
    pkl = os.path.join(protein_dir, "potts.pkl")
    npz = os.path.join(protein_dir, "potts.npz")
    wt_seqs = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))
    if os.path.exists(pkl):
        return potts_mod.load_pickle(protein_dir, dtype, device)
    if os.path.exists(npz):
        return potts_mod.load_npz(npz, wt_seqs[0], dtype, device)
    if not allow_synthetic:
        raise FileNotFoundError(f"no potts.pkl/potts.npz under {protein_dir}")
    warnings.warn(
        f"{protein_dir}: no Potts artifact found (the reference repo's "
        "potts.pkl is a missing blob) — using deterministic synthetic "
        "parameters. Fit real ones with scripts/fit_potts.py.")
    return potts_mod.synthetic(wt_seqs[0], seed=0, dtype=dtype,
                               device=device)


def load_supervised_ensemble(protein_dir: str, n_members: int = 3,
                             device="cuda"):
    """The reference OnehotCNN checkpoints as a stacked ensemble."""
    paths = [os.path.join(protein_dir, f"onehot_cnn_seed={i}.pt")
             for i in range(n_members)]
    return convert.cnn_ensemble_from_numpy(
        torch_convert.onehot_cnn_ensemble(paths), device)


# Peak memory (torch.cuda.max_memory_allocated) of the one-piece transformer
# gradient: (bytes that do not grow with the chains, bytes per chain and
# sequence position). Measured by chip_smoke.py phase 12 (e) on an NVIDIA
# H100 80GB HBM3 at 700.00 W, bf16, random init, full width and depth
# (transformer-L with remat, as load_expert runs it), GFP (T = 237):
# transformer-S 4.40 GB at 128 chains and 34.01 GB at 1024 (the line
# through both); -M 13.71 GB at 128 (its 1024 did not fit the card) and -L
# 5.70 GB at 128, each over the bytes held before the gradient (weights and
# the rest).
ESM_GRAD_MEMORY = {
    "transformer-S": (174159945, 139403.5),
    "transformer-M": (367181312, 439905.4),
    "transformer-L": (1422482432, 140919.6),
}
ESM_GRAD_MEMORY["transformer"] = ESM_GRAD_MEMORY["transformer-M"]
ESM_MEMORY_SHARE = 0.8  # of the card's memory, for the one-piece gradient


def resolve_esm_chunk(esm_chunk: int, has_transformer: bool,
                      n_chains: int, name: str | None = None,
                      seq_len: int = 0,
                      card_bytes: int | None = None) -> int | None:
    """Map the --esm_chunk flag to an energy chunk_size.

    -1 -> one piece. Positive -> used as given. 0 -> auto, from the card's
    memory (``card_bytes``; None: no device limit, as on the CPU): one
    piece when the one-piece gradient's predicted peak, ``base + per *
    n_chains * seq_len`` by ``ESM_GRAD_MEMORY[name]``, fits in
    ``ESM_MEMORY_SHARE`` of the card; otherwise the largest chunk that
    fits (the fewest pieces). One piece without a transformer. (The JAX
    package's auto value is 16, from a TPU measurement; on an NVIDIA H100
    80GB HBM3 at 700.00 W the one-piece gradient of transformer-S at 128
    chains ran 4.4x faster than chunks of 16, PERF.md §5.)
    """
    if esm_chunk < 0:
        return None
    if esm_chunk > 0:
        return esm_chunk
    if not has_transformer or card_bytes is None:
        return None
    base, per = ESM_GRAD_MEMORY[name]
    budget = ESM_MEMORY_SHARE * card_bytes
    per_chain = per * seq_len
    if base + per_chain * n_chains <= budget:
        return None
    return max(1, int((budget - base) // per_chain))


# The MSA Transformer expert's gradient: peak memory (as ESM_GRAD_MEMORY:
# bytes that do not grow with the chains, bytes per chain and alignment
# token, over the bytes held before the gradient), without and with
# per-layer recomputation (remat). Measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W, bf16, random init, msa-1b's widths, GFP's 237 residues with 32
# rows (7,616 tokens a chain), the term's gradient alone: 2.45, 4.72 and
# 9.44 GB at 1, 2 and 4 chains without remat, 0.87, 1.74 and 3.48 GB at 2,
# 4 and 8 with it (the lines through the ends). The smaller configs take
# msa-1b's line (their tokens are narrower).
MSA_GRAD_MEMORY = {
    ("msa-1b", False): (116724053, 305987.9),
    ("msa-1b", True): (3511296, 57109.8),
}


def resolve_msa_grad(msa_chunk: int, n_chains: int, name: str,
                     tokens: int, card_bytes: int | None = None):
    """(chunk_size, remat) of the MSA Transformer expert's gradient for the
    --esm_chunk flag (also spelt --msa_expert_chunk): -1 one piece,
    positive that many chains a piece, both without recomputation; 0 auto
    from the card's memory (``card_bytes``; None, as on the CPU: one piece)
    by ``MSA_GRAD_MEMORY`` at ``tokens`` (rows x columns) a chain: without
    recomputation, the fewest pieces that fit in ``ESM_MEMORY_SHARE`` of
    the card; per-layer recomputation only where one chain does not fit
    without it. (On the
    H100, msa-1b over GFP's 32-row alignments, the gradient of 128 chains
    took 2.00 s without recomputation in pieces of 16 and 2.76 s with it in
    one piece: recomputation costs a forward, and pieces of thousands of
    tokens a chain cost nothing measurable.)"""
    if msa_chunk < 0:
        return None, False
    if msa_chunk > 0:
        return msa_chunk, False
    if card_bytes is None:
        return None, False
    budget = ESM_MEMORY_SHARE * card_bytes
    for remat in (False, True):
        base, per = MSA_GRAD_MEMORY.get((name, remat),
                                        MSA_GRAD_MEMORY["msa-1b", remat])
        per_chain = per * tokens
        fit = int((budget - base) // per_chain) if per_chain else n_chains
        if fit >= n_chains:
            return None, remat
        if fit >= 1:
            return -(-n_chains // -(-n_chains // fit)), remat
    return 1, True


def expert_terms(spec: str) -> dict:
    """The terms of ``--unsupervised_expert`` ('+'-joined): {"potts": bool,
    "esm": an ESM2 config (``transformer*``) or None, "msa": an
    ``msa_transformer.CONFIGS`` key or None, "unknown": the other terms};
    raises on ESM2 and the MSA Transformer together (the energy has one
    transformer slot)."""
    from ppde_tpu_torch.models import msa_transformer

    terms = spec.split("+")
    esm = [t for t in terms if t.startswith("transformer")]
    msa = [t for t in terms if t in msa_transformer.CONFIGS]
    if esm and msa:
        raise ValueError(f"--unsupervised_expert {spec!r}: one transformer "
                         f"expert at a time (ESM2 or the MSA Transformer)")
    return {"potts": "potts" in terms, "esm": esm[0] if esm else None,
            "msa": msa[0] if msa else None,
            "unknown": [t for t in terms if t != "potts" and t not in esm
                        and t not in msa]}


def msa_context(path: str, wt_seq: str, rows: int) -> list[str]:
    """The first ``rows - 1`` aligned rows of the a2m / FASTA ``path`` in
    file order (``io.load_msa``'s focus columns), each of the wild type's
    length: the MSA Transformer expert's context."""
    if rows < 2:
        raise ValueError(f"--msa_expert_rows {rows}: the query row and at "
                         f"least one context row")
    seqs = [s for _, s in pio.load_msa(path)][:rows - 1]
    if len(seqs) < rows - 1 or any(len(s) != len(wt_seq) for s in seqs):
        raise ValueError(
            f"{path}: need {rows - 1} aligned rows of the wild type's "
            f"length {len(wt_seq)}; got {len(seqs)} rows of lengths "
            f"{sorted({len(s) for s in seqs})}")
    return seqs


def build_protein_energy(args, device="cuda"):
    """Construct (energy, oracle=(params, apply), potts_params,
    oracle_params) for a protein run.

    args needs: protein_weights, protein, energy_function,
    unsupervised_expert, energy_lamda, n_chains, and optionally potts_npz,
    esm_weights, allow_random_esm, compute_dtype, cnn_chunk, pool_bwd,
    esm_chunk, and for an MSA Transformer term msa_expert_context,
    msa_expert_rows, msa_expert_weights (allow_random_esm and esm_chunk
    serve the one transformer slot, ESM2's or the MSA Transformer's). A
    term that is neither potts, ESM2 nor the MSA Transformer is left to the
    caller, with a warning (the CLI refuses it).
    """
    device = utils.resolve_device(device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt_seqs = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))
    wt_onehot = torch.from_numpy(codec.seqs_to_onehot(wt_seqs)).to(device)
    sup = load_supervised_ensemble(protein_dir, device=device)

    potts_npz = getattr(args, "potts_npz", None)
    if potts_npz:
        # an explicit fit: the expert energy and the oracle's evolutionary
        # feature both take this same params object
        pp = potts_mod.load_npz(potts_npz, wt_seqs[0], device=device)
    else:
        pp = load_potts(protein_dir, device=device)

    # 'potts+transformer[-S/M/L]' or 'potts+msa-1b' composes PoE terms
    # (reference energy.py:83-89); each model's config key is its term
    terms = expert_terms(args.unsupervised_expert)
    if terms["unknown"]:
        warnings.warn(f"--unsupervised_expert {args.unsupervised_expert!r}: "
                      f"no expert here answers to {terms['unknown']}; the "
                      f"energy leaves them out")
    esm_name, msa_name = terms["esm"], terms["msa"]
    card = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else None)
    transformer, chunk = None, None
    if esm_name is not None:
        from ppde_tpu_torch.models import esm2

        transformer = esm2.load_expert(
            esm_name, wt_seqs[0],
            weights_path=getattr(args, "esm_weights", None),
            allow_random=getattr(args, "allow_random_esm", False),
            device=device)
        chunk = resolve_esm_chunk(getattr(args, "esm_chunk", 0), True,
                                  args.n_chains, esm_name, len(wt_seqs[0]),
                                  card)
    elif msa_name is not None:
        from ppde_tpu_torch.models import msa_transformer

        rows = getattr(args, "msa_expert_rows", 32)
        context = msa_context(args.msa_expert_context, wt_seqs[0], rows)
        chunk, remat = resolve_msa_grad(
            getattr(args, "esm_chunk", 0), args.n_chains, msa_name,
            rows * (len(wt_seqs[0]) + 1), card)
        transformer = msa_transformer.load_expert(
            msa_name, wt_seqs[0], context,
            weights_path=getattr(args, "msa_expert_weights", None),
            allow_random=getattr(args, "allow_random_esm", False),
            remat=remat, device=device)

    cdt = (torch.bfloat16 if getattr(args, "compute_dtype", "f32") == "bf16"
           else None)
    cnn_chunk = getattr(args, "cnn_chunk", 0) or None
    if cnn_chunk is None and args.n_chains > 256:
        cnn_chunk = 128
    pool_bwd = getattr(args, "pool_bwd", "split")
    if args.energy_function == "supervised":
        en = energy_mod.protein_supervised(sup, wt_onehot, compute_dtype=cdt,
                                           cnn_chunk=cnn_chunk,
                                           pool_bwd=pool_bwd)
    else:
        en = energy_mod.protein_poe(
            pp if terms["potts"] else None, sup, args.energy_lamda,
            wt_onehot, transformer=transformer, chunk_size=chunk,
            compute_dtype=cdt, cnn_chunk=cnn_chunk, pool_bwd=pool_bwd)

    orc = oracle_mod.load(protein_dir, potts_params=pp, device=device)
    return en, (orc, oracle_mod.apply), pp, orc


def make_initial_protein_population(protein_dir: str, n_chains: int,
                                    device="cuda") -> torch.Tensor:
    """n_chains copies of the wild type's one-hot [n_chains, L, V]."""
    wt_seqs = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))
    wt_onehot = torch.from_numpy(codec.seqs_to_onehot(wt_seqs))
    return wt_onehot.repeat(n_chains, 1, 1).to(utils.resolve_device(device))


def potts_provenance(protein_dir: str, potts_npz: str | None = None) -> str:
    """Which Potts parameters a run used: 'reference-pkl', 'refit' (an npz
    in the protein directory), 'npz:<path>' (an explicit --potts_npz), or
    'synthetic' (the deterministic fallback)."""
    if potts_npz:
        return f"npz:{potts_npz}"
    if os.path.exists(os.path.join(protein_dir, "potts.pkl")):
        return "reference-pkl"
    if os.path.exists(os.path.join(protein_dir, "potts.npz")):
        return "refit"
    return "synthetic"


def _q(v, qs=(0.2, 0.4, 0.5, 0.6, 0.8, 0.9, 1.0)):
    v = np.asarray(v, dtype=np.float64)
    return {f"p{int(q * 100)}": round(float(np.quantile(v, q)), 4)
            for q in qs}


def cell_summary(args, run_dir, *, population, wt_onehot, oracle_scores,
                 fitness, energy, potts_scores, transformer_scores,
                 steps_per_sec, wall_steps_per_sec,
                 potts_provenance) -> dict:
    """Machine-readable summary of a run (the JAX package's keys):
    diversity, exploration, score quantiles, throughput, the config and
    provenance needed to read them without the run directory, and, when
    ``transformer_scores`` is not None, the MSA-Transformer's evolutionary
    density with the scorer that gave it."""
    em, es = metrics.exploration(population, wt_onehot)
    summary = {
        "protein": args.protein,
        "sampler": args.sampler,
        "seed": args.seed,
        "n_iters": args.n_iters,
        "n_chains": args.n_chains,
        "energy_function": args.energy_function,
        "unsupervised_expert": args.unsupervised_expert,
        "energy_lamda": args.energy_lamda,
        "nmut_threshold": args.nmut_threshold,
        "reference_reverse": bool(getattr(args, "ppde_reference_reverse",
                                          False)),
        "run_signature": args.run_signature,
        "potts_provenance": potts_provenance,
        "diversity_pct": round(metrics.diversity_pct(population), 2),
        "exploration_mean": round(em, 3),
        "exploration_std": round(es, 3),
        "oracle_logfit": _q(oracle_scores),
        "pred_fitness": _q(fitness),
        "energy": _q(energy),
        "potts_delta": _q(potts_scores),
        "steps_per_sec": round(float(steps_per_sec), 2),
        "wall_steps_per_sec": round(float(wall_steps_per_sec), 2),
        "run_dir": str(run_dir),
        # stable copy location (if any): post-hoc density scoring
        # (scripts/eval_proteins.py --update_summary) updates both files
        "summary_json": getattr(args, "summary_json", "") or None,
    }
    if transformer_scores is not None:
        summary["evolutionary_density"] = _q(transformer_scores)
        summary["msa_transformer_model"] = args.msa_transformer_model
        summary["msa_transformer_weights"] = args.msa_transformer_weights
    return summary


def dump_config(args, path):
    with open(path, "w") as f:
        plain = (int, float, str, bool, type(None))
        json.dump({k: (v if isinstance(v, plain) else str(v))
                   for k, v in vars(args).items()}, f, indent=2)


def apply_mesh(energy: energy_mod.Energy, pop, dp: int | None, tp: int = 1,
               ep: int = 1, sp: int = 1):
    """Shard a built protein energy over a (dp, ep, tp, sp) device mesh;
    returns (mesh, energy, pop), as the JAX package's ``apply_mesh``.

    One process per device (``torchrun``; ``parallel/mesh.make_mesh``),
    the group's backend that of ``pop``'s device. The Potts couplings split
    by columns over tp (kernel A on the rank's block), the supervised
    ensemble's members over ep when ep divides their count (kernel B on the
    rank's members; whole otherwise), the ESM2 expert's heads and hidden
    units over tp, and with ``sp`` > 1 its residual stream's sequence over
    sp through the module-level ``esm2.SP_CONSTRAIN`` hook, set or cleared
    on every call (an expert's apply_fn closure picks it up unchanged).
    Over dp, the returned energy evaluates the rank's slice of the
    population and gathers its outputs (``mesh.shard_energy``): the
    sampler runs unchanged and replicated on the whole population, which
    is returned as it is.
    """
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.parallel import mesh as pmesh

    if "ctx" in energy.params.get("tr", {}) and (tp > 1 or sp > 1):
        raise ValueError("the MSA Transformer expert runs whole on each "
                         "rank: tp and sp must be 1")
    mesh = pmesh.make_mesh(dp=dp, ep=ep, tp=tp, sp=sp, device=pop.device)
    # set OR clear: a later apply_mesh (or a single-device energy) in the
    # same process must not inherit a hook over a stale mesh
    esm2.SP_CONSTRAIN = pmesh.sp_constraint(mesh) if sp > 1 else None
    params = dict(energy.params)
    if "potts" in params:
        params["potts"] = pmesh.shard_potts(params["potts"], mesh)
    if "tr" in params:
        params["tr"] = pmesh.shard_esm(params["tr"], mesh)
    if "sup" in params:
        params["sup"] = pmesh.shard_ensemble(params["sup"], mesh)
    # built anew, so that the energy prepares the rank's shards once
    return mesh, pmesh.shard_energy(energy.with_params(params), mesh), pop
