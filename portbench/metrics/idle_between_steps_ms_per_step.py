"""idle_between_steps_ms_per_step: device idle time a step while the host
was in the sampler's own work between steps, by the program's spans: the
gaps of the traced window whose middle lies in ``sampler.setup``,
``sampler.segment_end`` (sync, records to the host) or ``sampler.finish``."""
from portbench import program_spans

SPANS = ("sampler.setup", "sampler.segment_end", "sampler.finish")


def read(run):
    prog = program_spans.of_run(run)
    if not prog or "sampler.step" not in prog["entries"]:
        return None
    return sum(prog["idle_s"].get(n, 0.0) for n in SPANS) * 1e3 \
        / run["steps"]
