"""The float32 rates tool's SASS parsing, on the CPU (its probe and the
kernel library run only on the card)."""

import collections

import pytest

from swtpu_torch.tools import fp32_rates

# two kernels as cuobjdump -sass prints them: an outer loop around an inner
# one, and a lone loop; each ends in the BRA-to-self after EXIT
SASS = """
        Function : _Z3onev
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   FMNMX R4, R2, R5, !PT ;
        /*0030*/               @P0 FSEL R6, R4, R2, P1 ;
        /*0040*/                   ISETP.GE.AND P0, PT, R7, 0x10, PT ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   IADD3 R8, R8, 0x1, RZ ;
        /*0070*/              @!P2 BRA 0x10 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
        Function : _Z3twov
        /*0000*/                   FADD R2, R2, R3 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_functions_and_hot_loop():
    funcs = dict(fp32_rates.functions(SASS))
    assert list(funcs) == ["_Z3onev", "_Z3twov"]
    one = funcs["_Z3onev"]
    assert [op for _, op, _ in one][:5] == ["MOV", "FADD", "FMNMX", "FSEL", "ISETP"]
    # the innermost loop [0x20, 0x50], not the outer [0x10, 0x70] nor the
    # BRA-to-self after EXIT
    assert fp32_rates.hot_loop(one) == ["FMNMX", "FSEL", "ISETP", "BRA"]
    assert fp32_rates.hot_loop(funcs["_Z3twov"]) == ["FADD", "BRA"]
    assert fp32_rates.hot_loop([(0, "FADD", " R1, R2, R3 ")]) == []


@pytest.mark.parametrize("name, label", [
    ("void (anonymous namespace)::stream_wavefront_kernel<16, 0, 2>(Args)",
     "wavefront rows=16 tail-acc"),
    ("void stream_wavefront_kernel<(int)8, (int)2, (int)2>(Args)", "wavefront rows=8 chained"),
    ("void stream_wavefront_kernel<16, 1, 2>(Args)", None),  # ripple-H: rows 1 only
    ("void stream_wavefront_kernel<16, 0, 0>(Args)", None),  # int32
    ("void column_kernel<4, 2, false>(Args)", "column rpl=4 B4"),
    ("void column_kernel<(int)8, (int)2, (bool)1>(Args)", "column rpl=8 B5 tile"),
    ("void column_kernel<2, 2, false>(Args)", None),
    ("void column_x2_kernel<8, false>(Args)", None),
])
def test_float32_label(name, label):
    assert fp32_rates.float32_label(name) == label


def test_pipes_hold_the_recurrences_opcodes():
    assert fp32_rates.FMA_PIPE & fp32_rates.ALU_PIPE == set()
    assert {"FADD"} <= fp32_rates.FMA_PIPE
    assert {"FMNMX", "FSEL", "FSETP", "ISETP", "SEL"} <= fp32_rates.ALU_PIPE
    body = collections.Counter(fp32_rates.hot_loop(dict(fp32_rates.functions(SASS))["_Z3onev"]))
    assert sum(body[k] for k in fp32_rates.ALU_PIPE) == 3


def test_main_needs_a_gpu(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["fp32_rates"])
    assert fp32_rates.main() == 1
    assert "no CUDA device" in capsys.readouterr().out
