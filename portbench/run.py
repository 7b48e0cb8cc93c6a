"""The port's benchmark: one run of one cell.

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Runs from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the program (``ppde_tpu_torch/``), on one CUDA device.
Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (chain-steps), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, also printed as the last lines of standard error. Exits
non-zero and prints no result without a CUDA device, or when a module of
JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _err(msg: str) -> None:
    print(f"[portbench +{time.perf_counter() - T_START:.1f}s] {msg}",
          file=sys.stderr, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.find_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        _err(f"needs {chips} CUDA device(s); found {found}")
        return 2
    device = torch.device("cuda", 0)
    _err("set-up: imports and the device found")
    out = harness.run(args.workload, spec, args.seed, args.seconds,
                      bool(args.trace), device, T_START, log=_err)
    # after the window: nvidia-smi is the harness's, not the set-up's
    _err(f"card: {card_line()}")
    bad = harness.forbidden_modules()
    if bad:
        _err(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for name, c in out["checks"].items():
        _err(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
