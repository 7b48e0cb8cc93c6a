"""The nvcc build helpers of ppde_tpu_torch that need no GPU: readable kernel
names and the one-line-per-kernel ptxas report that chip_smoke.py prints."""
import pytest

from ppde_tpu_torch.ops import _build


@pytest.mark.parametrize("mangled,readable", [
    # nvcc's own name for the anonymous namespace of a source file
    ("_ZN51_GLOBAL__N__645ab541_18_flash_attention_cu_5695502f2rs11attn_fwd"
     "_rsILi24EEEvPK13__nv_bfloat16S4_S4_PS2_ii", "rs::attn_fwd_rs<24>"),
    ("_ZN12_GLOBAL__N_12rs14attn_bwd_dq_rsILi64EEEvPK13__nv_bfloat16",
     "rs::attn_bwd_dq_rs<64>"),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li32EEEvPKT_",
     "attn_fwd_kernel<bf16,32>"),
    ("_ZN12_GLOBAL__N_118attn_bwd_dq_kernelIfLi16EEEvPKT_",
     "attn_bwd_dq_kernel<float,16>"),
    ("_Z12potts_finishPKfPfi", "potts_finish"),
])
def test_kernel_name(mangled, readable):
    assert _build.kernel_name(mangled) == readable


def test_ptxas_report_one_line_per_kernel():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12rs11attn_fwd_rsILi24EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12rs11attn_fwd_rsILi24EEEvPK13__nv_bfloat16
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z12potts_finishPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _Z12potts_finishPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
ptxas /tmp/x.ptx, line 9; warning : Performance Advisory (C7515) wgmma serialized
ptxas /tmp/x.ptx, line 9; warning : Performance Advisory (C7519) on registers
"""
    lines = _build.ptxas_report(log)
    assert lines[0] == ("rs::attn_fwd_rs<24>: Used 168 registers, used 1 "
                        "barriers, 8 bytes cumulative stack size; 8 bytes "
                        "stack frame, 4 bytes spill stores, 8 bytes spill "
                        "loads")
    assert lines[1].startswith("potts_finish: Used 32 registers; 0 bytes")
    # performance remarks are kept, except the routine C7519
    assert len(lines) == 3 and "(C7515)" in lines[2]
