"""ppde_tpu_torch's instrumentation (profiling.py): spans that are shared
no-ops with no profiler and land in the Chrome trace, nested where the work
happens, under one; the one registry of launch counters behind the kernel
wrappers' old attribute names; the reading of a trace by program span.
CPU only: the kernel spans (``kernel.*``) are held on the card
(``test_torch_port_kernels_cuda.py``)."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppde_tpu_torch import codec, energy, profiling
from ppde_tpu_torch.models import cnn, esm2, potts
from ppde_tpu_torch.ops import (attention_fused, cnn_fused, potts_fused,
                                rotary_fused, row_attention_fused)
from ppde_tpu_torch.samplers.protein import ppde

WT = "ACDEFGHIKLMNPQRSTVWY"  # 20 residues
FWD_KINDS = ("embed", "norm", "qkv", "rotary", "attn_out", "ffn", "head")
OLD_ATTRIBUTES = {
    potts_fused: {"launches": "potts_energy",
                  "launches_f32": "potts_energy_f32"},
    cnn_fused: {"launches": "cnn_ensemble",
                "launches_f32": "cnn_ensemble_f32",
                "launches_wide": "cnn_ensemble_wide",
                "launches_wide_f32": "cnn_ensemble_wide_f32"},
    attention_fused: {"launches_fwd": "flash_attention_fwd",
                      "launches_bwd": "flash_attention_bwd",
                      "launches_fwd_kt": "flash_attention_fwd_kt",
                      "launches_bwd_kt": "flash_attention_bwd_kt"},
    rotary_fused: {"launches_fwd": "qkv_rotary_fwd",
                   "launches_bwd": "qkv_rotary_bwd"},
    row_attention_fused: {"launches_fwd": "row_attention_fwd",
                          "launches_bwd": "row_attention_bwd"},
}


def traced_spans(tmp_path, fn):
    """(fn's result, the program spans of its Chrome trace, sorted by
    start) with fn run under torch.profiler on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("name") in profiling.SPANS),
                   key=lambda e: e["ts"])
    assert all(e["cat"] == "user_annotation" for e in spans)
    return out, spans


def inside(a, b):
    return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]


def parent(spans, e):
    """The innermost other span that holds e."""
    outer = [s for s in spans if s is not e and inside(e, s)]
    return min(outer, key=lambda s: s["dur"])["name"] if outer else None


def test_span_off_is_the_shared_noop_and_counters_count():
    assert not profiling.recording()
    off = profiling.span("energy")
    assert off is profiling.span("kernel.a")
    with off:
        pass
    before = profiling.counters()
    profiling.count("potts_energy")
    profiling.count("cnn_ensemble_wide", 3)
    after = profiling.counters()
    assert after["potts_energy"] == before["potts_energy"] + 1
    assert after["cnn_ensemble_wide"] == before["cnn_ensemble_wide"] + 3
    assert {k: v for k, v in after.items()
            if k not in ("potts_energy", "cnn_ensemble_wide")} == {
        k: v for k, v in before.items()
        if k not in ("potts_energy", "cnn_ensemble_wide")}
    after["potts_energy"] = -1  # a snapshot, not the registry
    assert profiling.counters()["potts_energy"] >= 0


@pytest.mark.parametrize("module", list(OLD_ATTRIBUTES),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_wrapper_attributes_read_the_registry(module):
    for attr, name in OLD_ATTRIBUTES[module].items():
        assert getattr(module, attr) == profiling.counters()[name]
        profiling.count(name)
        assert getattr(module, attr) == profiling.counters()[name]
    with pytest.raises(AttributeError):
        module.launches_of_nothing  # noqa: B018


def small_ppde(n=6):
    tp = potts.synthetic(WT, min_pos=2, max_pos=17, seed=0,
                         coupling_scale=0.1, device="cpu")
    ens = cnn.init_ensemble(torch.Generator().manual_seed(0), 2,
                            input_size=len(WT))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([WT]))
    return energy.protein_poe(tp, ens, 2.0, wt_oh), wt_oh.repeat(n, 1, 1)


def test_ppde_run_spans_nest_as_documented(tmp_path):
    en, pop = small_ppde()
    steps, log_every = 7, 3

    def run():
        return ppde.run(en, pop, steps, 2, 17,
                        cfg=ppde.PPDEConfig(nmut_threshold=4),
                        generator=torch.Generator().manual_seed(5),
                        log_every=log_every, quiet=True, device="cpu")

    plain = run()
    res, spans = traced_spans(tmp_path, run)
    for field in ("best_x", "best_energy", "energy_history", "final_x",
                  "n_accepted"):
        np.testing.assert_array_equal(getattr(res, field),
                                      getattr(plain, field))
    names = [s["name"] for s in spans]
    segments = -(-steps // log_every)
    assert names.count("sampler.step") == steps
    assert names.count("energy") == steps + 1
    assert names.count("sampler.segment_end") == segments
    assert names.count("ppde.proposal") == names.count("ppde.accept") == steps
    assert names.count("energy.cnn") == names.count("energy.potts") == \
        steps + 1
    assert names[0] == "sampler.setup" and names[-1] == "sampler.finish"
    want_parent = {"sampler.step": None, "sampler.segment_end": None,
                   "sampler.setup": None, "sampler.finish": None,
                   "ppde.proposal": "sampler.step",
                   "ppde.accept": "sampler.step",
                   "energy.cnn": "energy", "energy.potts": "energy"}
    for s in spans:
        if s["name"] in want_parent:
            assert parent(spans, s) == want_parent[s["name"]], s["name"]
        if s["name"] == "energy":
            assert parent(spans, s) in ("sampler.step", "sampler.setup")
    # the step's energy lies between its proposal and its accept
    step = next(s for s in spans if s["name"] == "sampler.step")
    inner = [s["name"] for s in spans if inside(s, step) and s is not step
             and parent(spans, s) == "sampler.step"]
    assert inner == ["ppde.proposal", "energy", "ppde.accept"]


@pytest.fixture
def tiny_esm2(monkeypatch):
    monkeypatch.setitem(esm2.CONFIGS, "tiny",
                        dict(layers=2, dim=40, heads=5, ffn=80))
    return "tiny"


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_esm2_spans_by_kind_and_same_bits(tmp_path, tiny_esm2, remat):
    tr = esm2.load_expert(tiny_esm2, WT, allow_random=True,
                          dtype=torch.float32, remat=remat, device="cpu")
    ens = cnn.init_ensemble(torch.Generator().manual_seed(1), 2,
                            input_size=len(WT))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([WT]))
    en = energy.protein_poe(None, ens, 1.0, wt_oh, transformer=tr)
    x = wt_oh.repeat(3, 1, 1)
    x[1, 4] = torch.eye(20)[7]
    x[2, 11] = torch.eye(20)[2]

    def call():
        with torch.no_grad():
            return en.energy_and_grad(en.params, x)

    off = call()
    on, spans = traced_spans(tmp_path, call)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert not profiling._grad_hooks and not profiling._open_grad
    names = {s["name"] for s in spans}
    assert {f"esm2.{k}" for k in FWD_KINDS} <= names
    assert {f"esm2.bwd.{k}" for k in FWD_KINDS} <= names
    back = next(s for s in spans if s["name"] == "esm2.backward")
    assert parent(spans, back) == "energy.esm2"
    for s in spans:
        if s["name"].startswith("esm2.bwd."):
            assert parent(spans, s) == "esm2.backward", s["name"]
        elif s["name"] in {f"esm2.{k}" for k in FWD_KINDS}:
            # remat recomputes a layer's forward inside its backward
            assert parent(spans, s) == "energy.esm2" or (
                remat and parent(spans, s).startswith("esm2.bwd.")), \
                s["name"]
    # the backward kinds follow the forward's in reverse, and do not
    # overlap
    bwd = [s for s in spans if s["name"].startswith("esm2.bwd.")]
    assert bwd[0]["name"] == "esm2.bwd.head"
    assert bwd[-1]["name"] == "esm2.bwd.embed"
    for a, b in zip(bwd, bwd[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
        assert a["name"] != b["name"]


def test_esm2_gradient_outside_grad_spans_registers_no_hook(tiny_esm2):
    """A training-style backward (no ``grad_spans``) under the profiler
    opens no backward span and leaves none open."""
    params = esm2.init(torch.Generator().manual_seed(0), tiny_esm2,
                       dtype=torch.float32)
    x = torch.from_numpy(esm2.seq_to_esm_onehot(WT))[None]
    with profile(activities=[ProfilerActivity.CPU]):
        y = esm2.pseudo_log_likelihood(params, x.requires_grad_(True), 5)
        y.sum().backward()
    assert not profiling._open_grad
    assert x.grad is not None


def write_trace(path, events):
    path.mkdir()
    with open(path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_device_by_span_on_a_handmade_trace(tmp_path):
    """Spans energy > kernel.b, energy > esm2.backward (main thread) >
    esm2.bwd.ffn and kernel.c_bwd (another thread); kernels by the
    innermost span open at their launch; one launch call missing, bounded
    by its neighbours; one kernel launched outside any program span, and a
    span that is not the program's (ignored)."""
    def x(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    ev = [
        x("portbench.energy", "user_annotation", 0, 100),
        x("energy", "user_annotation", 1, 98),
        x("kernel.b", "user_annotation", 2, 10),
        x("esm2.backward", "user_annotation", 20, 60),
        x("esm2.bwd.ffn", "user_annotation", 21, 20, tid=2),
        x("kernel.c_bwd", "user_annotation", 45, 10, tid=2),
        x("cudaLaunchKernel", "cuda_runtime", 3, 1, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 22, 1, tid=2, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 30, 1, tid=2, correlation=4),
        x("cuLaunchKernel", "cuda_driver", 46, 1, tid=2, correlation=5),
        x("cudaMemcpyAsync", "cuda_runtime", 150, 1, correlation=6),
        x("wide::fwd_simt", "kernel", 5, 40, correlation=1),
        x("elementwise", "kernel", 50, 3, correlation=2),
        x("gemm", "kernel", 60, 4, correlation=3),  # launch missing
        x("elementwise", "kernel", 70, 2, correlation=4),
        x("attn_bwd_dq", "kernel", 80, 7, correlation=5),
        x("Memcpy DtoH", "gpu_memcpy", 151, 5, correlation=6),
    ]
    got = profiling.device_by_span(write_trace(tmp_path / "t", ev))
    assert got["unmatched"] == 1
    assert got["kernel.b"] == {"us": 40.0, "kernels": 1}
    assert got["esm2.bwd.ffn"] == {"us": 3.0 + 4.0 + 2.0, "kernels": 3}
    assert got["kernel.c_bwd"] == {"us": 7.0, "kernels": 1}
    assert got[None] == {"us": 5.0, "kernels": 0}
    assert "portbench.energy" not in got
