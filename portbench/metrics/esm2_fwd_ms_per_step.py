"""esm2_fwd_ms_per_step: device time a step of ESM2's forward, by the
program's spans: the work launched inside ``esm2.embed``, ``esm2.norm``,
``esm2.qkv``, ``esm2.rotary``, ``esm2.attn_out``, ``esm2.ffn`` and
``esm2.head`` (kernel C is innermost under ``kernel.c``, so not counted)."""
from portbench import program_spans

NAMES = tuple("esm2." + k for k in ("embed", "norm", "qkv", "rotary",
                                    "attn_out", "ffn", "head"))


def read(run):
    prog = program_spans.of_run(run)
    if not prog or not any(n in prog["entries"] for n in NAMES):
        return None
    return sum(prog["device_s"].get(n, 0.0) for n in NAMES) * 1e3 \
        / run["steps"]
