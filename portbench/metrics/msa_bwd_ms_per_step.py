"""msa_bwd_ms_per_step: device time a step of the MSA Transformer expert's
backward, by the program's spans: the work launched inside ``msa.backward``
and its kinds ``msa.bwd.*`` (kernels T' and C' are innermost under
``kernel.t_bwd`` and ``kernel.c_bwd``, so not counted)."""
from portbench import program_spans


def read(run):
    prog = program_spans.of_run(run)
    if not prog or "msa.backward" not in prog["entries"]:
        return None
    return sum(v for k, v in prog["device_s"].items()
               if k == "msa.backward" or k.startswith("msa.bwd.")) * 1e3 \
        / run["steps"]
