"""The product-of-experts terms beside Potts and the CNN ensemble, one module
each.

A configuration names an expert by a top-level key that is the name of a
module here (``"esm2": {...}`` is ``esm2.py``); a null value is no expert.
The rest of the benchmark reaches an expert only through its module, which
gives one name for each job:

  * ``cli_term(cfg)``: its part of the CLI's ``--unsupervised_expert``
    (``potts+<term>``);
  * ``cli_args(cfg, files)``: the CLI arguments it takes, from the files its
    ``write`` made;
  * ``check_dtype(cfg)``: raises ``ValueError`` where the program cannot
    serve the configuration's stated type;
  * ``write(gen, cfg, path, wt, device)``: its weights (and any data it
    needs for the wild type ``wt``), drawn from the one generator after
    Potts and the CNN, into the protein directory ``path``; returns the
    files it wrote, by name;
  * ``reference_term(protein_dir, cfg, device)``: its plain float32 term, a
    function ``(x [B, L, 20] one-hots, r) -> score [B]`` (differentiable),
    where ``r`` marks each tensor the served expert holds in its stated type;
    ``REFERENCE_BLOCK``: the chains a block of the reference's autograd;
  * ``control_round(t)``: ``t`` rounded to the precision below the stated
    one, which the control applies at each ``r``;
  * ``forward_flops(cfg, L)``: the FLOPs of one forward over a sequence of L
    residues, for ``step_mfu_pct``;
  * ``KERNELS``: {key: (wrapper module, wrapper attribute, launch counter
    attribute)} of its kernels, beside A's and B's in ``trace.KERNELS``;
  * ``SPAN_PREFIX``: the prefix of the program's spans inside it.
"""
from __future__ import annotations

import importlib
import pkgutil


def names() -> list[str]:
    """Every expert module's name, sorted."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__)
                  if not m.name.startswith("_"))


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def modules() -> list:
    """Every expert module, configured or not."""
    return [module(n) for n in names()]


def of(config: dict) -> list[tuple[str, object, dict]]:
    """(key, module, settings) of each expert the configuration holds, in the
    configuration's order."""
    known = set(names())
    return [(k, module(k), v) for k, v in config.items()
            if k in known and v is not None]
