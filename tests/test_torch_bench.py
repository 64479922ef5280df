"""swtpu_torch.bench and swtpu_torch.bench_scaling on the CPU: swtpu's
GCUPS arithmetic, its headline packing and seed, every stage at a tiny
size against its oracle window, a failing stage's exit, and the scaling
scripts' lines against swtpu's (the card's numbers come from
chip_smoke.py's phase "bench")."""

import json

import bench as ref_bench
import bench_scaling as ref_scaling
import numpy as np
import pytest
import torch

import swtpu.testing.regress as ref_regress
from swtpu.bank.streams import pack_streams as ref_pack_streams
from swtpu.ops.scan import sw_scores_scan as ref_scan
from swtpu_torch import bench, bench_scaling
from swtpu_torch.ops import scan as port_scan
from swtpu_torch.ops import stream as port_stream
from swtpu_torch.testing import regress as port_regress

CPU = torch.device("cpu")
KEYS = ["metric", "value", "unit", "vs_baseline"]


def scripted_clock(times, reps):
    """A stand-in for swtpu bench's time.time: for each chain length in
    order, 0 and 0 around the warm run, then 0 and the length's canned
    seconds around each of `reps` timed runs."""
    ticks = iter([t for k in times for t in [0.0, 0.0] + [0.0, times[k]] * reps])
    return lambda: next(ticks)


@pytest.mark.parametrize("times", [
    {1: 0.1, 33: 0.5},  # a trusted slope between the floor and 3x it
    {1: 0.4, 33: 0.5},  # the delta under 0.3 T[k2]: the slope untrusted
    {1: 0.69, 33: 1.0},  # a trusted slope past 3x the floor: clamped
    {1: 0.0, 33: 1.0},  # a slope under the floor: the floor
    {1: 0.6, 33: 0.5},  # a negative delta
    {33: 0.5},  # one chain length: no slope
    {1: 0.01, 17: 0.2},  # stream_small's ks
])
def test_gcups_of_equals_swtpu_formula(monkeypatch, times):
    """swtpu's own stage_stream_chain and _measure_scan_chain, run on a tiny
    chain (64 reads on 8 streams at rows 1) whose kernel call is faked to
    give the oracle's window, under a clock that gives each chain length
    its canned time: their gcups, floor and slope are gcups_of's."""
    import jax.numpy as jnp

    import swtpu.ops.pallas_stream as ref_pallas_stream
    from swtpu.oracle import score_many_vs_one

    B, S = 64, 8
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, size=128).astype(np.int8)
    t = rng.integers(0, 4, size=(B, 128)).astype(np.int8)
    b = ref_pack_streams(q, t, n_streams=S, rows=1)
    strip = np.zeros((int(b.emit_step[:64].max()) + 1, S), np.int32)
    strip[b.emit_step[:64], b.emit_stream[:64]] = score_many_vs_one(q, t[:64])

    def fake_strip_call(*args, **kwargs):
        return jnp.asarray(strip)

    measure = ref_bench._measure_scan_chain

    def measure_tiny(**kw):  # the stage's own ks and reps, at B reads
        return measure(**{**kw, "B": B})

    for name, value in (("S_STREAMS", S), ("ROWS", 1), ("KS", tuple(times)),
                        ("SCORE_WIDTH", None), ("CHUNK", None),
                        ("_enable_compile_cache", lambda: None),
                        ("_measure_scan_chain", measure_tiny),
                        ("time", type("Clock", (), {"time": staticmethod(
                            scripted_clock(times, 4))}))):
        monkeypatch.setattr(ref_bench, name, value)
    monkeypatch.setattr(ref_pallas_stream, "_strip_call", fake_strip_call)
    ref = ref_bench.stage_stream_chain()
    gcups, floor, slope = bench.gcups_of(b.cells, times)
    assert b.cells == B * 128 * 128
    assert (ref["gcups"], ref["floor"], ref["slope"]) == (gcups, floor, slope or 0.0)
    assert (slope is None) == (ref["slope"] == 0.0)


def test_headline_pack_equals_swtpu():
    """The port's headline inputs at swtpu's seed and packing (512 streams,
    rows 16), at a reduced B: the same reads, cells and window indices."""
    B = 4096
    q, t, b = bench.stream_inputs(B)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(q, rng.integers(0, 4, size=128).astype(np.int8))
    np.testing.assert_array_equal(t, rng.integers(0, 4, size=(B, 128)).astype(np.int8))
    assert (bench.S_STREAMS, bench.ROWS, bench.STATE_DTYPE) == (
        ref_bench.S_STREAMS, ref_bench.ROWS, ref_bench.STATE_DTYPE) == (512, 16, "float32")
    ref = ref_pack_streams(q, t, n_streams=512, rows=16)
    assert b.cells == ref.cells == B * 128 * 128
    np.testing.assert_array_equal(b.emit_stream[:64], ref.emit_stream[:64])
    np.testing.assert_array_equal(b.emit_step[:64], ref.emit_step[:64])
    np.testing.assert_array_equal(b.stream, ref.stream)


@pytest.fixture
def tiny(monkeypatch):
    """Every stage at a tiny size: 64 reads on 8 streams at rows 1, ks
    (1, 2), 64 and 128 pairs."""
    for name, value in (("HEADLINE_READS", 64), ("SMALL_READS", 64), ("S_STREAMS", 8),
                        ("ROWS", 1), ("KS", (1, 2)), ("COLUMN_PAIRS", (64, 128)),
                        ("CPU_PAIRS", (64, 128))):
        monkeypatch.setattr(bench, name, value)


@pytest.mark.parametrize("stage,width", [("stream_chain", None), ("stream_chain", 12),
                                         ("stream_chain_i32", None),
                                         ("stream_small", None), ("product_sharded", None)])
def test_stream_stage_passes_its_window(tiny, monkeypatch, stage, width):
    monkeypatch.setattr(bench, "SCORE_WIDTH", width)
    res = bench.STAGES[stage](CPU)
    assert res["cells"] == 64 * 128 * 128
    assert list(res["times_s"]) == ["1", "2"]
    assert 0 < res["floor"] <= res["gcups"] <= 3 * res["floor"]
    want = "int32" if width or stage.endswith("i32") else "float32"
    assert res["state_dtype"] == want


def test_column_stage_passes_its_window(tiny):
    res = bench.STAGES["column"](CPU)
    assert [c for c, _ in res["points"]] == [64 * 128 * 128, 128 * 128 * 128]
    assert res["gcups"] > 0


def test_cpu_stage_scores_equal_swtpu_scan(monkeypatch):
    """The cpu stage at its seed: its first size's pairs (1,024, swtpu's)
    and scores equal swtpu's sw_scores_scan's; the second size (2,048 here,
    4,096 in the stage) is the next draw of the same generator."""
    monkeypatch.setattr(bench, "CPU_PAIRS", (1024, 2048))
    calls = []
    real = port_scan.sw_scores_scan

    def spy(q, t, *a):
        out = real(q, t, *a)
        calls.append((q.numpy().copy(), t.numpy().copy(), out.numpy().copy()))
        return out

    monkeypatch.setattr(port_scan, "sw_scores_scan", spy)
    res = bench.stage_cpu()
    assert res["gcups"] > 0
    assert sorted({len(q) for q, _, _ in calls}) == [1024, 2048]
    rng = np.random.default_rng(0)
    for B in (1024, 2048):
        q, t, got = next(c for c in calls if len(c[0]) == B)
        np.testing.assert_array_equal(q, rng.integers(0, 4, size=(B, 128)).astype(np.int8))
        np.testing.assert_array_equal(t, rng.integers(0, 4, size=(B, 128)).astype(np.int8))
        if B == 1024:  # swtpu's scan on the first size (the second adds only time)
            np.testing.assert_array_equal(got, np.asarray(ref_scan(q, t)))


@pytest.mark.parametrize("stage", ["stream_chain", "product_sharded"])
def test_corrupted_window_exits_1_with_no_json_line(tiny, monkeypatch, capsys, stage):
    real = port_stream._strip_call

    def corrupted(*a, **kw):
        strip = real(*a, **kw)
        strip[:, 3] += 1  # stream 3: reads 3, 11, 19, ... of the window
        return strip

    monkeypatch.setattr(port_stream, "_strip_call", corrupted)
    monkeypatch.setitem(bench.PLANS, "cpu", (stage,))
    assert bench.main("cpu") == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert f"# stage {stage}: FAILED" in err
    assert "8 of 64 scores differ from the oracle; first at reads [3, 11," in err


def test_raising_stage_exits_1_with_no_json_line(tiny, monkeypatch, capsys):
    def broken(device):
        raise RuntimeError("no kernel")

    monkeypatch.setitem(bench.STAGES, "cpu", broken)
    assert bench.main("cpu") == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "# stage cpu: FAILED" in err and "RuntimeError: no kernel" in err


def test_main_prints_swtpu_line(monkeypatch, capsys):
    """swtpu's plan on the card ends at the headline; main prints every
    stage on stderr and the last one's number in swtpu's line."""
    assert bench.PLANS["cuda"] == ("product_sharded", "stream_chain")
    monkeypatch.setitem(bench.PLANS, "cpu", ("column", "stream_chain"))
    monkeypatch.setitem(bench.STAGES, "column", lambda d: {"gcups": 9999.0})
    monkeypatch.setitem(bench.STAGES, "stream_chain", lambda d: {"gcups": 1477.74})
    assert bench.main("cpu") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert list(line) == KEYS and len(out.splitlines()) == 1
    assert line == {"metric": ref_bench.METRIC, "value": 1477.7, "unit": "GCUPS",
                    "vs_baseline": round(1477.74 / ref_bench.BASELINE_GCUPS, 3)}
    assert "# stage column: ok" in err and "# stage stream_chain: ok" in err
    assert err.splitlines()[0] == "# device: cpu"


def test_stage_flag_prints_bench_result(tiny, monkeypatch, capsys):
    assert bench._cli(["--device", "cpu", "--stage", "column"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("BENCH_RESULT ") and json.loads(out[len("BENCH_RESULT "):])["gcups"] > 0
    monkeypatch.setitem(bench.STAGES, "column", lambda d: 1 / 0)
    assert bench._cli(["--device", "cpu", "--stage", "column"]) == 1
    assert "BENCH_RESULT" not in capsys.readouterr().out


@pytest.mark.parametrize("run", [lambda: bench.main("cuda"),
                                 lambda: bench_scaling.main("cuda"),
                                 lambda: bench_scaling.main_multihost("cuda")])
def test_cuda_without_a_card_names_the_cpu_flag(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        run()


def test_bench_scaling_lines(monkeypatch, capsys):
    """A mesh of 4 CPU shards: a row a size (swtpu's stream backend past one
    device), the efficiency line and the note; one CPU device: the scan,
    one row and swtpu's warning."""
    monkeypatch.setitem(bench_scaling.PER_DEV, "cpu", 16)
    bench_scaling.main("cpu", devices=[CPU] * 4)
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert all(list(r) == KEYS for r in rows)
    assert [r["metric"] for r in rows] == [
        "reads/s @ 1 device(s)", "reads/s @ 2 device(s)", "reads/s @ 4 device(s)",
        "scaling efficiency 1->4 devices"]
    assert all(r["value"] > 0 and r["unit"] == "reads/s" for r in rows[:3])
    # swtpu rounds the efficiency and its ratio to 0.8 from one unrounded
    # number, each to 0.001
    assert rows[3]["unit"] == "ratio" and abs(
        rows[3]["vs_baseline"] - rows[3]["value"] / 0.8) <= 0.0005 + 0.0005 / 0.8 + 1e-12
    assert "measures the harness" in err
    calls = []
    real = port_scan.sw_scores_scan
    monkeypatch.setattr(port_scan, "sw_scores_scan",
                        lambda *a: calls.append(1) or real(*a))
    bench_scaling.main("cpu")
    out, err = capsys.readouterr()
    assert [json.loads(line)["metric"] for line in out.splitlines()] == [
        "reads/s @ 1 device(s)"]
    assert "single device" in err and calls


def test_main_multihost_lines_equal_swtpu(monkeypatch, capsys):
    """run_multihost faked in both packages: the same calls (arrays, modes,
    process counts) and the same kinds of line, in order."""
    seen = {"port": [], "swtpu": []}

    def fake(side):
        def run_multihost(q, t, ids, nprocs=2, topk=4, mode="pairs", lens=None, **kw):
            seen[side].append((q, t, ids, nprocs, topk, mode, lens))
        return run_multihost

    monkeypatch.setattr(port_regress, "run_multihost", fake("port"))
    monkeypatch.setattr(ref_regress, "run_multihost", fake("swtpu"))
    bench_scaling.main_multihost("cpu")
    port_out = capsys.readouterr().out.splitlines()
    ref_scaling.main_multihost()
    ref_out = capsys.readouterr().out.splitlines()
    assert len(port_out) == len(ref_out) == 8
    got, want = map(lambda lines: [json.loads(x) for x in lines], (port_out, ref_out))
    assert [(r["metric"], r["unit"]) for r in got] == [(r["metric"], r["unit"]) for r in want]
    assert all(list(r) == KEYS and r["value"] > 0 for r in got)
    assert len(seen["port"]) == len(seen["swtpu"]) == 6
    for a, b in zip(seen["port"], seen["swtpu"]):
        assert a[3:6] == b[3:6]
        for x, y in zip(a[:3] + a[6:], b[:3] + b[6:]):
            np.testing.assert_array_equal(x, y)
