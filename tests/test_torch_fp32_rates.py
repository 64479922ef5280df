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
    # a column kernel's run loop: the outer [0x10, 0x70]
    assert fp32_rates.run_loop(one) == ["FADD", "FMNMX", "FSEL", "ISETP", "BRA", "IADD3",
                                        "BRA"]
    assert fp32_rates.run_loop([(0, "FADD", " R1, R2, R3 ")]) == []


# a run loop [0x10, 0xd0] around a column loop [0x20, 0xc0] of two
# columns, each a carry round whose vote's forward branch skips a scan
COLUMN_LOOPS = """
        Function : _Z5tilev
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, [R4.64] ;
        /*0020*/                   FADD R2, R2, R3 ;
        /*0030*/                   VOTE.ANY P0, P0 ;
        /*0040*/              @!P0 BRA 0x60 ;
        /*0050*/                   SHFL.UP PT, R5, R6, 0x2, RZ ;
        /*0060*/                   FMNMX R4, R2, R5, !PT ;
        /*0070*/                   VOTE.ANY P0, P0 ;
        /*0080*/              @!P0 BRA 0xb0 ;
        /*0090*/                   SHFL.UP PT, R5, R6, 0x2, RZ ;
        /*00a0*/                   SHFL.UP PT, R5, R6, 0x4, RZ ;
        /*00b0*/                   ISETP.GE.AND P1, PT, R7, 0x10, PT ;
        /*00c0*/               @P1 BRA 0x20 ;
        /*00d0*/              @!P2 BRA 0x10 ;
        /*00e0*/                   EXIT ;
"""


def test_column_run_counts_the_random_reads_path():
    """B5's column loop: the code outside it once a run, its code less what
    each column's first vote skips once a pass (32 / 2 passes); a kernel
    with one loop level (B4) counts its run loop."""
    (_, ops), = fp32_rates.functions(COLUMN_LOOPS)
    run = fp32_rates.column_run(ops)
    column = ["FADD", "VOTE", "BRA", "FMNMX", "VOTE", "BRA", "ISETP", "BRA"]
    assert collections.Counter(run) == collections.Counter(["LDG", "BRA"] + column * 16)
    one = dict(fp32_rates.functions(SASS))["_Z3onev"]
    assert fp32_rates.column_run(one) == fp32_rates.run_loop(one)
    assert fp32_rates.column_run([(0, "FADD", " R1, R2, R3 ")]) == []


@pytest.mark.parametrize("name, label", [
    ("void (anonymous namespace)::stream_wavefront_kernel<16, 0, 2>(Args)",
     "wavefront rows=16 tail-acc"),
    ("void stream_wavefront_kernel<(int)8, (int)2, (int)2>(Args)", "wavefront rows=8 chained"),
    ("void stream_wavefront_kernel<16, 1, 2>(Args)", None),  # ripple-H: rows 1 only
    ("void stream_wavefront_kernel<16, 0, 0>(Args)", None),  # int32
    ("void column_scores_kernel<16, 2>(Args)", "column lanes=16 B4"),
    ("void column_tile_kernel<(int)2>(Args)", "column B5 tile"),
    ("void column_scores_kernel<(int)4, (int)2>(Args)", None),  # not a main shape
    ("void column_scores_kernel<32, 0>(Args)", None),  # int32
    ("void column_x2_kernel<8, false>(Args)", None),
    ("void column_scores_kernel<32, 2, true>(Args)", "column B5 tile"),
    ("void column_scores_kernel<(int)32, (int)2, (bool)1>(Args)", "column B5 tile"),
    ("void column_scores_kernel<32, 2, false>(Args)", "column lanes=32 B4"),
    ("void column_scores_kernel<(int)4, (int)2, (bool)0>(Args)", None),  # not a main shape
    ("void column_scores_kernel<32, 0, true>(Args)", None),  # int32
    ("void (anonymous namespace)::stream_chain_kernel<16, 2, false>(ChainArgs)",
     "chain rows=16"),
    ("void stream_chain_kernel<(int)8, (int)2, (bool)0>(ChainArgs)", "chain rows=8"),
    ("void stream_chain_kernel<16, 2, true>(ChainArgs)", None),  # the per-tile contract
    ("void stream_chain_kernel<16, 0, false>(ChainArgs)", None),  # int32
    ("void (anonymous namespace)::stream_chain_kernel<16, 2, false, true>(ChainArgs)",
     "chain rows=16"),
    ("void stream_chain_kernel<(int)8, (int)2, (bool)0, (bool)1>(ChainArgs)", "chain rows=8"),
    ("void stream_chain_kernel<16, 2, false, false>(ChainArgs)", None),  # no pad shortcut
    ("void stream_chain_kernel<16, 2, true, true>(ChainArgs)", None),  # the per-tile contract
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


@pytest.mark.parametrize("name, label", [
    ("void (anonymous namespace)::stream_wavefront_x2_kernel<8, 0, 5>(Args)",
     "wavefront rows=8 tail-acc bfloat16"),
    ("void stream_wavefront_x2_kernel<(int)8, (int)2, (int)5>(Args)",
     "wavefront rows=8 chained bfloat16"),
    ("void stream_wavefront_x2_kernel<8, 1, 5>(Args)", None),  # ripple-H
    ("void stream_wavefront_x2_kernel<8, 0, 3>(Args)", None),  # int16
    ("void stream_wavefront_x2_kernel<4, 0, 5>(Args)", None),  # not the main rows
    ("void stream_wavefront_kernel<16, 0, 2>(Args)", None),  # float32
    ("void (anonymous namespace)::stream_chain_kernel<8, 5, false>(ChainArgs)",
     "chain rows=8 bfloat16"),
    ("void stream_chain_kernel<(int)8, (int)5, (bool)1>(ChainArgs)", None),  # one tile
    ("void stream_chain_kernel<8, 3, false>(ChainArgs)", None),  # int16
    ("void (anonymous namespace)::stream_chain_x2_kernel<8, 5, false, true>(ChainArgs)",
     "chain rows=8 bfloat16"),
    ("void stream_chain_x2_kernel<(int)8, (int)5, (bool)0, (bool)0>(ChainArgs)", None),
    ("void stream_chain_x2_kernel<8, 5, true, true>(ChainArgs)", None),  # one tile
    ("void stream_chain_x2_kernel<8, 4, false, true>(ChainArgs)", None),  # uint16
])
def test_bfloat16_label(name, label):
    assert fp32_rates.bfloat16_label(name) == label


def test_bfloat16_opcodes_and_the_mma_form():
    """HFMA2.MMA keeps its pipe apart from HFMA2; the bfloat16 adds count on
    the FMA pipe and HMNMX2 on the ALU pipe."""
    sass = """
        Function : _Z5bf16v
        /*0000*/                   HADD2.BF16_V2 R2, R2, R3 ;
        /*0010*/                   HFMA2.MMA.BF16_V2.RELU R4, R2, R5, R6 ;
        /*0020*/                   HFMA2.BF16_V2 R4, R2, R5, R6 ;
        /*0030*/                   HMNMX2.BF16_V2 R7, R4, R2, !PT ;
        /*0040*/                   BRA 0x0 ;
"""
    ops = [op for _, op, _ in dict(fp32_rates.functions(sass))["_Z5bf16v"]]
    assert ops == ["HADD2", "HFMA2.MMA", "HFMA2", "HMNMX2", "BRA"]
    pipes = fp32_rates.by_pipe(collections.Counter(ops))
    assert pipes == {"FMA": 2, "ALU": 1, "MMA": 1}


def test_model_lanes_is_chip_smokes_bound():
    """The model at the nominal rates: float32 91.4 / 88.0 results an SM a
    clock a wavefront / column cell; bfloat16 (64 instructions on both
    pipes, two results each, max(diag + s, 0) in its add's HFMA2.RELU)
    213.3, 182.9 without that fusion; at measured rates the slowest pipe's."""
    wave, col = fp32_rates.CELLS["wavefront"], fp32_rates.CELLS["column"]
    assert wave == (10, 3, 1) and col == (11, 3, 1)
    assert fp32_rates.model_lanes("float32", *wave) == pytest.approx(10 / (7 / 64))
    assert fp32_rates.model_lanes("float32", *col) == pytest.approx(88.0)
    assert fp32_rates.model_lanes("float32", 10, 3) == fp32_rates.model_lanes("float32", *wave)
    assert fp32_rates.model_lanes("bfloat16", *wave) == pytest.approx(10 / (6 / 128))
    assert fp32_rates.model_lanes("bfloat16", 10, 3) == pytest.approx(10 / (7 / 128))
    measured = {"FMA": 63.60, "ALU": 63.56}
    assert fp32_rates.model_lanes("bfloat16", *wave, rates=measured) == pytest.approx(
        10 / (6 / (2 * 63.56)))
    # more adds than maxes (E1's chains): the FMA pipe sets the time
    assert fp32_rates.model_lanes("bfloat16", 19, 11) == pytest.approx(19 / (11 / 128))
    assert fp32_rates.pipe_rates({"FMA": 63.6, "ALU": 63.5}) == {
        "FMA": 63.6, "ALU": 63.5, "MMA": 63.6}


def test_chip_smoke_lanes_equal_the_tools_model():
    """chip_smoke.py's bounds take the tool's model for the float types (a
    wavefront cell, a column cell, E1's and E2's steps) and the type's
    lanes for the integer ones."""
    import chip_smoke

    assert chip_smoke.cell_lanes("wavefront", "float32", 10) == pytest.approx(80 / 0.875)
    assert chip_smoke.cell_lanes("column", "float32", 11) == pytest.approx(88.0)
    assert chip_smoke.cell_lanes("wavefront", "bfloat16", 10) == pytest.approx(640 / 3)
    assert chip_smoke.e2_lanes("full", "bfloat16") == pytest.approx(179.2)
    assert chip_smoke.e2_lanes("nosel", "bfloat16") == pytest.approx(192.0)
    assert chip_smoke.e2_lanes("minimal", "bfloat16") == pytest.approx(256.0)
    assert chip_smoke.e2_lanes("full", "float32") == pytest.approx(1792 / 22)
    assert chip_smoke.e1_lanes("addmax", "float32") == pytest.approx(128.0)
    assert chip_smoke.e1_lanes("addmax", "bfloat16") == pytest.approx(19 / (11 / 128))
    assert chip_smoke.cell_lanes("wavefront", "int16", 8) == 128
    assert chip_smoke.lanes_of("int32", 8) == 64
