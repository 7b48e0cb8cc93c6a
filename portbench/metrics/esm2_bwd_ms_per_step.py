"""esm2_bwd_ms_per_step: device time a step of ESM2's backward, by the
program's spans: the work launched inside ``esm2.backward`` and its kinds
``esm2.bwd.*`` (kernel C' is innermost under ``kernel.c_bwd``, so not
counted)."""
from portbench import program_spans


def read(run):
    prog = program_spans.of_run(run)
    if not prog or "esm2.backward" not in prog["entries"]:
        return None
    return sum(v for k, v in prog["device_s"].items()
               if k == "esm2.backward" or k.startswith("esm2.bwd.")) * 1e3 \
        / run["steps"]
