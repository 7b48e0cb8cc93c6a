"""The readings that a cell's limits are set from: the program's gaps over
many seeds, and the control's over some of them, in one process.

    python -m portbench.control --workload NAME --seconds S \
        --seeds N [N ...] [--control_seeds K]

Each seed is a whole run of the cell (``harness.run``: its own weights,
set-up and window at the cell's own sizes); the first K seeds also compute
the control (``reference.Precision("control")``) at the window's judged
states and read its gaps. Prints one JSON line a seed, then the largest
program reading and the smallest control reading of each gap. The
benchmark's own runs never run the control.

``--plant dx_chunk`` runs the program with a fault planted beneath the
timed path (``plant_dx_chunk``), to read what the checks make of it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def plant_dx_chunk(n_chains: int):
    """A fault for the checks: kernel B's gradient doubled in one chunk of
    every energy call (the first of a batch split in chunks, or the first
    eighth of a whole batch, as one chunk of 128 is of 1024 chains), its
    fitness untouched, so that only the gradient is wrong. Returns the
    undo."""
    from ppde_tpu_torch.ops import cnn_fused

    fn = cnn_fused.ensemble_apply_and_grad
    calls = [0]

    def faulty(stacked, x, *a, **k):
        fit, dx = fn(stacked, x, *a, **k)
        chunks = max(1, n_chains // x.shape[0])
        first = calls[0] % chunks == 0
        calls[0] += 1
        if not first:
            return fit, dx
        rows = x.shape[0] if chunks > 1 else max(1, x.shape[0] // 8)
        dx = dx.clone()
        dx[:rows] *= 2.0
        return fit, dx

    cnn_fused.ensemble_apply_and_grad = faulty

    def undo():
        cnn_fused.ensemble_apply_and_grad = fn
    return undo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--plant", choices=("dx_chunk",), default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import compare, harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    if args.plant == "dx_chunk":
        plant_dx_chunk(int(spec["traffic"]["n_chains"]))
    prog: dict[str, list] = {g: [] for g in compare.GAPS}
    ctrl: dict[str, list] = {g: [] for g in compare.GAPS}
    for i, seed in enumerate(args.seeds):
        out = harness.run(args.workload, spec, seed, args.seconds, False,
                          device, time.perf_counter(),
                          readings=("control" if i < args.control_seeds
                                    else "program"),
                          log=lambda m: print(m, file=sys.stderr,
                                              flush=True))
        readings = out["readings"]
        line = {"seed": seed, "plant": args.plant, "correct": out["correct"],
                "program": readings["program"],
                "control": readings["control"],
                "chain_steps_per_s":
                    out["metrics"]["chain_steps_per_s"]["value"]}
        for g in compare.GAPS:
            prog[g].append(line["program"][g])
            if line["control"] is not None:
                ctrl[g].append(line["control"][g])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload,
                      "program_max": {g: max(v) for g, v in prog.items()},
                      "control_min": {g: min(v) if v else None
                                      for g, v in ctrl.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
