"""Kernels C and C' (or kernel B) of several trees of the repository,
timed in one call.

    python tools/ab_attention.py ROOT [ROOT ...] [--transformer] [--sass]
        [--cases Z,T,HD,DTYPE ...]
    python tools/ab_attention.py ROOT [ROOT ...] --cnn

Each ROOT is a checkout of the repository: this tree as ``.``, the parent
commit unpacked by ``git archive`` into a git-ignored directory. For each
ROOT, in the order given, a child process imports ROOT's ppde_tpu_torch and
ROOT's chip_smoke.py, builds ROOT's kernels, and prints one JSON line: for
the transformer path's two calls in bf16, (Z, T, hd) = (320, 237, 24) (the
gradient in chunks of 16 chains) and (2560, 237, 24) (in one piece), the
forward and backward times by CUDA events (``chip_smoke.time_ms``) and the
device time of each kernel by name (``profile_port_step.us_by_kernel`` of
this tree). ``--cases`` replaces those two calls by others (DTYPE f32 or
bf16), and adds each one's ``scaled_dot_product_attention`` forward and
forward-plus-backward-less-forward times. ``--transformer`` adds ROOT's chip_smoke.py phase 6 (the potts +
transformer-S sampler in both chunkings: steps/s). ``--sass`` adds, for each kernel of ROOT's bf16 hd = 24
instances, its instruction count and its most frequent opcodes
(``cuobjdump -sass`` of the built library). ``--cnn`` times kernel B
instead: the wide kernel at CNN_LENGTHS residues (C = L, 128 random
sequences, a seeded 3-member ensemble, split), float32 and bf16, by CUDA
events; and the SHA-256 of GFP's outputs of the tc and simt kernels (128
and 1024 chains, both types and pool modes), which the last line compares
with the first root's (equal: the same bits). Give the
roots as parent, change, change, parent to see the spread beside the
difference. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import subprocess
import sys

from profile_port_step import ATTN_SHAPES as SHAPES, us_by_kernel


def sass_opcodes(lib_path: str, namer, n_top: int = 24) -> dict:
    """{kernel: {"instructions": n, "top": {opcode: count}}} for the bf16
    hd = 24 kernels (template argument 24) in a built library's SASS;
    ``namer`` makes a mangled name readable."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        if "Li24E" not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        found[namer(name.strip())] = {
            "instructions": len(ops),
            "top": dict(collections.Counter(ops).most_common(n_top))}
    return found


def parse_case(text: str) -> tuple:
    """"Z,T,HD,DTYPE" -> (Z, T, hd, "f32" or "bf16")."""
    z, t, hd, dtype = text.split(",")
    if dtype not in ("f32", "bf16"):
        raise argparse.ArgumentTypeError(f"DTYPE must be f32 or bf16: {text}")
    return int(z), int(t), int(hd), dtype


# kernel B's wide lengths (--cnn): both sides of the row tiles, GFP's
# nearest wide length, phase 16's two, one past ESM2's longest
CNN_LENGTHS = (261, 400, 1022, 1100)


def cnn_child(torch, chip_smoke, dev, out) -> None:
    """``--cnn``: kernel B's wide times and the hashes of GFP's tc / simt
    outputs."""
    import hashlib

    from ppde_tpu_torch.models import cnn
    from ppde_tpu_torch.ops import cnn_fused

    out["cnn"] = []
    for L in CNN_LENGTHS:
        ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(L),
                                3, input_size=L)
        x = chip_smoke.random_onehot(
            torch, torch.Generator(device=dev).manual_seed(L + 1), 128, L,
            dev)
        for dtype in (torch.float32, torch.bfloat16):
            prep = cnn_fused.prepare_ensemble(ens, dtype)
            out["cnn"].append({"L": L, "dtype": str(dtype).split(".")[-1],
                               "ms": chip_smoke.time_ms(
                                   lambda: cnn_fused.ensemble_apply_and_grad(
                                       prep, x), 5)})
    out["cnn_bits"] = {}
    L = len(chip_smoke.GFP_WT)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=L)
    for B in (128, 1024):
        x = chip_smoke.random_onehot(
            torch, torch.Generator(device=dev).manual_seed(B), B, L, dev)
        for dtype in (torch.float32, torch.bfloat16):
            prep = cnn_fused.prepare_ensemble(ens, dtype)
            for pool in ("split", "first"):
                fit, dx = cnn_fused.ensemble_apply_and_grad(prep, x, None,
                                                            pool)
                key = f"{str(dtype).split('.')[-1]}_{B}_{pool}"
                for name, t in (("fit", fit), ("dx", dx)):
                    out["cnn_bits"][f"{key}_{name}"] = hashlib.sha256(
                        t.cpu().numpy().tobytes()).hexdigest()


def child(root: str, transformer: bool, sass: bool, cases=None,
          cnn=False) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from ppde_tpu_torch.ops import _build, attention_fused

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    dev = torch.device("cuda")
    out = {"root": root, "card": card, "build_s": build_s, "shapes": []}
    if cnn:
        cnn_child(torch, chip_smoke, dev, out)
        print("AB " + json.dumps(out), flush=True)
        return
    for Z, T, hd, dtype in cases or [(*s, "bf16") for s in SHAPES]:
        gen = torch.Generator(device=dev).manual_seed(Z + T + hd)
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        q, k, v, dout = ((torch.randn((Z, T, hd), generator=gen, device=dev)
                          * 0.5).to(tdt) for _ in range(4))
        calls = {"fwd": lambda: attention_fused.flash_attention(q, k, v),
                 "bwd": lambda: attention_fused.flash_attention_bwd(
                     q, k, v, dout)}
        r = {"Z": Z, "T": T, "hd": hd, "dtype": dtype}
        for way, fn in calls.items():
            r[f"{way}_ms"] = chip_smoke.time_ms(fn, 20)
            r[f"{way}_us_by_kernel"] = us_by_kernel(torch, fn)
        if cases:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qs = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def fwd_bwd():
                torch.autograd.grad(sdpa(*qs, scale=1.0), qs, dout)
            r["fwd_sdpa_ms"] = chip_smoke.time_ms(
                lambda: sdpa(q, k, v, scale=1.0), 20)
            r["bwd_sdpa_ms"] = chip_smoke.time_ms(fwd_bwd, 20) - r[
                "fwd_sdpa_ms"]
        out["shapes"].append(r)
    if transformer:
        from ppde_tpu_torch import codec, energy as energy_mod
        from ppde_tpu_torch.models import cnn, esm2, potts
        from ppde_tpu_torch.ops import cnn_fused, potts_fused
        from ppde_tpu_torch.samplers.protein import ppde

        # built here, not taken from ROOT's chip_smoke.py: the roots may
        # predate any shared definition
        counters = {"potts_energy": (potts_fused, "launches"),
                    "cnn_ensemble": (cnn_fused, "launches"),
                    "flash_attention_fwd": (attention_fused, "launches_fwd"),
                    "flash_attention_bwd": (attention_fused, "launches_bwd")}
        runs, _ = chip_smoke.phase_transformer(
            torch, codec, energy_mod, potts, cnn, esm2, ppde, counters, dev,
            card)
        out["transformer"] = [
            {key: r[key] for key in ("chunk_size", "steps_per_sec",
                                     "wall_steps_per_sec", "launches")}
            for r in runs]
    if sass:
        lib = glob.glob(os.path.join(root, "ppde_tpu_torch", "_build_out",
                                     "libflash_attention-*.so"))
        out["sass"] = sass_opcodes(
            sorted(lib)[0], getattr(_build, "kernel_name", lambda n: n))
    print("AB " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--transformer", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--cases", nargs="+", type=parse_case, default=None,
                    metavar="Z,T,HD,DTYPE")
    ap.add_argument("--cnn", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.transformer, args.sass, args.cases,
              args.cnn)
        return 0
    rc, bits = 0, []
    for root in args.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        cmd += [f for f, on in (("--transformer", args.transformer),
                                ("--sass", args.sass),
                                ("--cnn", args.cnn)) if on]
        if args.cases:
            cmd += ["--cases", *(",".join(map(str, c)) for c in args.cases)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not lines:
            print(f"{root}: exit {res.returncode}\n{res.stdout[-3000:]}"
                  f"\n{res.stderr[-3000:]}", flush=True)
            rc = 1
            continue
        print(lines[-1][3:], flush=True)
        bits.append(json.loads(lines[-1][3:]).get("cnn_bits"))
    if args.cnn and not rc:
        print(json.dumps({"gfp_bits_equal_to_first_root": {
            root: b == bits[0] for root, b in zip(args.roots[1:], bits[1:])}}),
            flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
