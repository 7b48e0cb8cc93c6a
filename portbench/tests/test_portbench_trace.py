"""Launch-site attribution on a small recorded trace, and the spans."""
import pytest

from portbench import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded():
    """A step: the sampler launches k0; the energy's span holds kernel A's
    k1, a launch of its own (k2), and on autograd's thread C''s copy and
    k3, whose launch call is missing: the launches with the nearest ids
    (at 25 and 50) bound it, and only the energy's span is open over both;
    the sampler launches k4 after the energy."""
    P = trace.PREFIX
    ev = [
        _x("user_annotation", "window.ppde_run", 0, 100),
        _x("user_annotation", P + "energy", 10, 60),
        _x("user_annotation", P + "kernel_a", 12, 8),
        _x("user_annotation", P + "kernel_c_bwd", 40, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=100),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=101),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=102),
        _x("cuda_driver", "cuLaunchKernel", 50, 1, tid=2, corr=104),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 1, corr=105),
        _x("cpu_op", "aten::add", 78, 6),
        _x("kernel", "k0", 6, 4, tid=7, corr=100),
        _x("kernel", "k1", 16, 10, tid=7, corr=101),
        _x("kernel", "k2", 26, 4, tid=7, corr=102),
        _x("kernel", "k3", 45, 5, tid=7, corr=103),
        _x("gpu_memcpy", "Memcpy DtoH", 52, 3, tid=7, corr=104),
        _x("kernel", "k4", 90, 5, tid=7, corr=105),
    ]
    return ev


def test_device_time_goes_to_the_launching_span():
    a = trace.Attribution(recorded())
    P = trace.PREFIX
    assert a.by_span == {None: 9.0, P + "kernel_a": 10.0, P + "energy": 9.0,
                         P + "kernel_c_bwd": 3.0}
    assert a.kernels_by_span == {None: 2, P + "kernel_a": 1,
                                 P + "energy": 2}
    assert a.unmatched == 1


def test_busy_time_top_ops_and_idle_gaps():
    a = trace.Attribution(recorded())
    # device busy: [6, 10], [16, 30], [45, 50], [52, 55], [90, 95]
    assert a.busy_us(0, 100) == 4 + 14 + 5 + 3 + 5
    top = a.top_ops(2)
    assert [t[0] for t in top] == ["k1", "k3"]
    assert [t[1] for t in top] == [pytest.approx(10e-6), pytest.approx(5e-6)]
    # the longest gaps: [55, 90] (the window's own host code at 72.5) and
    # [30, 45] (inside the energy's span at 37.5)
    gaps = a.idle_gaps(0, 100, n=2)
    assert [g[0] for g in gaps] == ["window.ppde_run", trace.ENERGY]
    assert [g[1] for g in gaps] == [pytest.approx(35e-6),
                                    pytest.approx(15e-6)]


def test_spans_wrap_the_kernel_wrappers_and_come_out_again():
    from ppde_tpu_torch.ops import attention_fused, cnn_fused, potts_fused

    before = (potts_fused.energy_and_grad, cnn_fused.ensemble_apply_and_grad,
              attention_fused._fwd_cuda, attention_fused._bwd_cuda)
    with trace.spans():
        inside = (potts_fused.energy_and_grad,
                  cnn_fused.ensemble_apply_and_grad,
                  attention_fused._fwd_cuda, attention_fused._bwd_cuda)
        assert all(a is not b for a, b in zip(before, inside))
    after = (potts_fused.energy_and_grad, cnn_fused.ensemble_apply_and_grad,
             attention_fused._fwd_cuda, attention_fused._bwd_cuda)
    assert after == before


def test_spans_reach_a_recorded_trace_on_the_cpu():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppde_tpu_torch.ops import potts_fused

    W = torch.randn(128, 128)
    W = W + W.T
    x = torch.zeros(2, 128)
    x[:, 3] = 1.0
    with trace.spans(), profile(activities=[ProfilerActivity.CPU]) as prof:
        f = trace.energy_span(lambda: potts_fused.energy_and_grad(
            W, torch.zeros(128), x))
        f()
    names = [e.name for e in prof.events()]
    assert trace.ENERGY in names and trace.PREFIX + "kernel_a" in names
