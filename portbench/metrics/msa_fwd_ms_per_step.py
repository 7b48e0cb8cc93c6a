"""msa_fwd_ms_per_step: device time a step of the MSA Transformer expert's
forward, by the program's spans: the work launched inside ``msa.embed``,
``msa.norm``, ``msa.qkv``, ``msa.row``, ``msa.col``, ``msa.attn_out``,
``msa.ffn`` and ``msa.head`` (kernels T and C are innermost under
``kernel.t`` and ``kernel.c``, so not counted)."""
from portbench import program_spans

NAMES = tuple("msa." + k for k in ("embed", "norm", "qkv", "row", "col",
                                   "attn_out", "ffn", "head"))


def read(run):
    prog = program_spans.of_run(run)
    if not prog or not any(n in prog["entries"] for n in NAMES):
        return None
    return sum(prog["device_s"].get(n, 0.0) for n in NAMES) * 1e3 \
        / run["steps"]
