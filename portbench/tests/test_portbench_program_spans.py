"""The program's own spans in a small recorded trace, and the three readers
that take their metrics from them."""
import ast

import pytest

from portbench import harness, program_spans, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded():
    """Two steps of a window [0, 200]: the set-up (its energy launches k0),
    step 1 (the proposal's k1; in the energy ESM2's embed launches k2, its
    backward's ffn kind, on autograd's thread, k3 and k4, whose launch
    call is missing: the calls at 34 and 52 bound it, and only
    esm2.backward is open over both; a copy launched inside kernel.c_bwd),
    the segment end, idle, step 2 (k5 in ppde.accept) and the finish (k6);
    the harness's own spans are not the program's."""
    P = trace.PREFIX
    return [
        _x("user_annotation", "window.ppde_run", 0, 200),
        _x("user_annotation", "sampler.setup", 1, 9),
        _x("user_annotation", "energy", 2, 6),
        _x("user_annotation", "sampler.step", 12, 50),
        _x("user_annotation", "ppde.proposal", 13, 5),
        _x("user_annotation", P + "energy", 19, 40),
        _x("user_annotation", "energy", 20, 38),
        _x("user_annotation", "energy.esm2", 21, 36),
        _x("user_annotation", "esm2.embed", 22, 4),
        _x("user_annotation", "esm2.backward", 30, 26),
        _x("user_annotation", "esm2.bwd.ffn", 31, 6, tid=2),
        _x("user_annotation", "kernel.c_bwd", 50, 4, tid=2),
        _x("user_annotation", "sampler.segment_end", 62, 40),
        _x("user_annotation", "sampler.step", 104, 40),
        _x("user_annotation", "ppde.accept", 130, 10),
        _x("user_annotation", "sampler.finish", 146, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 23, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 34, 1, tid=2, corr=4),
        _x("cuda_driver", "cuLaunchKernel", 52, 1, tid=2, corr=6),
        _x("cuda_runtime", "cudaLaunchKernel", 131, 1, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 189, 1, corr=8),
        _x("cpu_op", "aten::copy_", 64, 2),
        _x("kernel", "k0", 4, 6, tid=7, corr=1),
        _x("kernel", "k1", 15, 5, tid=7, corr=2),
        _x("kernel", "k2", 24, 6, tid=7, corr=3),
        _x("kernel", "k3", 35, 10, tid=7, corr=4),
        _x("kernel", "k4", 45, 20, tid=7, corr=5),
        _x("gpu_memcpy", "Memcpy DtoH", 65, 5, tid=7, corr=6),
        _x("kernel", "k5", 132, 18, tid=7, corr=7),
        _x("kernel", "k6", 190, 8, tid=7, corr=8),
    ]


def tables():
    return program_spans.read(trace.Attribution(recorded()), 0, 200)


def test_device_time_by_innermost_program_span():
    t = tables()
    assert t["device_s"] == pytest.approx({
        "energy": 6e-6, "ppde.proposal": 5e-6, "esm2.embed": 6e-6,
        "esm2.bwd.ffn": 10e-6, "esm2.backward": 20e-6,
        "kernel.c_bwd": 5e-6, "ppde.accept": 18e-6, "sampler.finish": 8e-6})
    assert t["kernels"] == {"energy": 1, "ppde.proposal": 1,
                            "esm2.embed": 1, "esm2.bwd.ffn": 1,
                            "esm2.backward": 1, "ppde.accept": 1,
                            "sampler.finish": 1}
    assert t["unmatched_launches"] == 1
    assert t["entries"]["sampler.step"] == 2
    assert t["entries"]["energy"] == 2
    assert not any(k.startswith(trace.PREFIX) or k == "window.ppde_run"
                   for k in t["entries"])


def test_idle_time_by_the_span_at_each_gap():
    # busy [4, 10], [15, 20], [24, 30], [35, 70], [132, 150], [190, 198]:
    # each gap goes to the innermost program span open at its middle
    assert tables()["idle_s"] == pytest.approx({
        "energy": 4e-6, "sampler.step": 5e-6, "esm2.embed": 4e-6,
        "esm2.bwd.ffn": 5e-6, "sampler.segment_end": 62e-6,
        "sampler.finish": 40e-6, program_spans.OUTSIDE: 2e-6})


def run_of(prog, steps=2):
    return {"trace": {"device_s": {}, "program": prog}, "steps": steps}


@pytest.mark.parametrize("name,want", [
    ("esm2_fwd_ms_per_step", 6e-6 * 1e3 / 2),
    ("esm2_bwd_ms_per_step", (10e-6 + 20e-6) * 1e3 / 2),
])
def test_esm2_readers(name, want):
    assert harness.reader(name)(run_of(tables())) == pytest.approx(want)


def test_idle_reader_sums_the_sampler_spans_between_steps():
    got = harness.reader("idle_between_steps_ms_per_step")(run_of(tables()))
    assert got == pytest.approx((62e-6 + 40e-6) * 1e3 / 2)


@pytest.mark.parametrize("name", ["esm2_fwd_ms_per_step",
                                  "esm2_bwd_ms_per_step",
                                  "idle_between_steps_ms_per_step"])
def test_readers_give_nothing_without_the_programs_spans(name):
    """A program without these spans (the parent's): empty tables, so
    the metric is left out and nothing raises."""
    bare = [e for e in recorded() if e["cat"] != "user_annotation"
            or e["name"].startswith(trace.PREFIX)]
    prog = program_spans.read(trace.Attribution(bare), 0, 200)
    assert prog["entries"] == {}
    assert harness.reader(name)(run_of(prog)) is None
    assert harness.reader(name)({"trace": None, "steps": 1}) is None


def test_of_run_gives_the_tables_the_harness_stored():
    run = {"trace": {"device_s": {}, "program": tables()}, "steps": 2}
    assert program_spans.of_run(run) is run["trace"]["program"]
    assert harness.reader("esm2_fwd_ms_per_step")(run) == pytest.approx(3e-3)


def test_of_run_without_a_traced_window_gives_nothing():
    assert program_spans.of_run({"trace": {"device_s": {}}}) is None
    assert program_spans.of_run({"trace": None}) is None


def test_program_spans_import_nothing_of_the_program():
    tree = ast.parse(open(program_spans.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module])
            assert not any(n.split(".")[0] in ("ppde_tpu_torch", "ppde_tpu")
                           for n in names)
