"""The port stands alone: its copies of swtpu's JAX-free modules (config,
oracle, io, the native packer, the event log, the score-line format)
behave exactly like the originals, and no file of the port imports swtpu."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import swtpu.config as ref_config
import swtpu.io.encode as ref_encode
import swtpu.io.fasta as ref_fasta
import swtpu.io.loader as ref_loader
import swtpu.oracle as ref_oracle
import swtpu.runtime.native as ref_native
from swtpu.server import format_score_line as ref_format_score_line
from swtpu.utils.metrics import BatchEvent as RefBatchEvent
from swtpu.utils.metrics import EventLog as RefEventLog
from swtpu_torch import config, oracle
from swtpu_torch.server import format_score_line
from swtpu_torch.io import encode, fasta, loader
from swtpu_torch.runtime import native
from swtpu_torch.utils.metrics import BatchEvent, EventLog
from swtpu_native_ref import use_swtpu_native

REPO = Path(__file__).resolve().parent.parent


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["Penalties", "SWConfig"])
def test_config_fields_and_defaults_equal_swtpu(name):
    got, want = getattr(config, name), getattr(ref_config, name)
    assert _fields(got) == _fields(want)
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    assert got.__dataclass_params__.frozen and want.__dataclass_params__.frozen


def test_default_penalties_equal_swtpu():
    assert config.DEFAULT_PENALTIES.astuple() == ref_config.DEFAULT_PENALTIES.astuple()
    assert config.Penalties(3, -1, -2, -1).astuple() == (3, -1, -2, -1)


def _pairs(seed, n=12, hi=40):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, size=rng.integers(0, hi)).astype(np.int8) for _ in range(n)]
    ts = [rng.integers(0, 4, size=rng.integers(0, hi)).astype(np.int8) for _ in range(n)]
    ts[0] = qs[0].copy()
    return qs, ts


@pytest.mark.parametrize("pen", [(5, -4, -12, -4), (2, -3, -4, -1)])
def test_oracle_equals_swtpu(pen):
    port_pen, ref_pen = config.Penalties(*pen), ref_config.Penalties(*pen)
    qs, ts = _pairs(sum(pen) + 50)
    for q, t in zip(qs, ts):
        assert oracle.sw_score_single(q, t, port_pen) == ref_oracle.sw_score_single(q, t, ref_pen)
        for w in (10, 12):
            assert oracle.sw_score_single_biased(q, t, port_pen, w) == (
                ref_oracle.sw_score_single_biased(q, t, ref_pen, w))
    B, m, n = len(qs), 40, 40
    qm = np.zeros((B, m), np.int8)
    tm = np.zeros((B, n), np.int8)
    ql = np.array([len(q) for q in qs])
    tl = np.array([len(t) for t in ts])
    for i, (q, t) in enumerate(zip(qs, ts)):
        qm[i, : len(q)] = q
        tm[i, : len(t)] = t
    got = oracle.sw_score_batch(qm, tm, ql, tl, port_pen)
    np.testing.assert_array_equal(got, ref_oracle.sw_score_batch(qm, tm, ql, tl, ref_pen))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(oracle.score_many_vs_one(qs[1], ts, port_pen),
                                  ref_oracle.score_many_vs_one(qs[1], ts, ref_pen))
    scores = np.array([-5, 0, 2047, 2048, 5000])
    for w in (10, 12):
        np.testing.assert_array_equal(oracle.biased_view(scores, w),
                                      ref_oracle.biased_view(scores, w))


def test_self_match_wraps_in_both_biased_oracles():
    seq = np.tile(np.arange(4, dtype=np.int8), 30)  # 120 bases: 600 > 2^9 - 1
    got = oracle.sw_score_single_biased(seq, seq, score_width=10)
    assert got == ref_oracle.sw_score_single_biased(seq, seq, score_width=10)
    assert got < 600 == oracle.sw_score_single(seq, seq)


FASTA = """>query the first
ACGTNacgt
TTGA
>db1
GGG

>db2 x
acgtACGTnnRY
>db3
"""


def test_read_fasta_and_split_equal_swtpu(tmp_path):
    path = tmp_path / "in.fa"
    path.write_text(FASTA)
    got, want = fasta.read_fasta(path), ref_fasta.read_fasta(path)
    assert [(r.name, r.seq) for r in got] == [(r.name, r.seq) for r in want]
    gq, gd = fasta.read_query_and_db(path)
    wq, wd = ref_fasta.read_query_and_db(path)
    assert [r.name for r in gq] == [r.name for r in wq] == ["query"]
    assert [(r.name, r.seq) for r in gd] == [(r.name, r.seq) for r in wd]
    out_port, out_ref = tmp_path / "port.fa", tmp_path / "ref.fa"
    fasta.write_fasta(out_port, got)
    ref_fasta.write_fasta(out_ref, want)
    assert out_port.read_bytes() == out_ref.read_bytes()
    bad = tmp_path / "bad.fa"
    bad.write_text("ACGT\n>x\nA\n")
    with pytest.raises(ValueError) as e:
        fasta.read_fasta(bad)
    with pytest.raises(ValueError) as e_ref:
        ref_fasta.read_fasta(bad)
    assert str(e.value) == str(e_ref.value)


def test_encoders_equal_swtpu():
    assert encode.BASE_CODES == ref_encode.BASE_CODES
    assert encode.CODE_BASES == ref_encode.CODE_BASES
    for strict in (True, False):
        seq = "ACGTNacgtRY"
        np.testing.assert_array_equal(encode.encode_seq(seq, strict),
                                      ref_encode.encode_seq(seq, strict))
        got = encode.encode_batch(["ACG", "", "TTTTA"], strict=strict)
        want = ref_encode.encode_batch(["ACG", "", "TTTTA"], strict=strict)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert encode.decode_seq([0, 1, 2, 3, 4]) == ref_encode.decode_seq([0, 1, 2, 3, 4])
    codes = np.random.default_rng(1).integers(0, 4, size=23).astype(np.int8)
    packed = encode.pack_2bit(codes)
    np.testing.assert_array_equal(packed, ref_encode.pack_2bit(codes))
    np.testing.assert_array_equal(encode.unpack_2bit(packed, 23),
                                  ref_encode.unpack_2bit(packed, 23))
    for args, fn, ref_fn in (
        ((np.array([0, 4]),), encode.pack_2bit, ref_encode.pack_2bit),
        ((np.zeros((2, 2)),), encode.pack_2bit, ref_encode.pack_2bit),
        ((["ACGT"], 2), encode.encode_batch, ref_encode.encode_batch),
    ):
        with pytest.raises(ValueError) as e:
            fn(*args)
        with pytest.raises(ValueError) as e_ref:
            ref_fn(*args)
        assert str(e.value) == str(e_ref.value)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("strict", [True, False])
def test_load_encoded_equals_swtpu(tmp_path, monkeypatch, use_native, strict):
    if not use_native:
        monkeypatch.setattr(native, "native_available", lambda: False)
        monkeypatch.setattr(ref_native, "native_available", lambda: False)
    path = tmp_path / "in.fa"
    path.write_text(FASTA)
    got = loader.load_encoded(path, strict=strict)
    want = ref_loader.load_encoded(path, strict=strict)
    assert isinstance(got, loader.EncodedDB)
    assert got.names == want.names
    for a, b in ((got.mat, want.mat), (got.lens, want.lens)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [r.tolist() for r in got] == [r.tolist() for r in want]
    assert len(got) == len(want) == 4


def test_native_library_builds_into_the_build_dir():
    from swtpu_torch.ops._build import build_dir

    assert native.native_available()
    path = native.library_path()
    assert path.parent == build_dir() and path.exists()
    assert path.name.startswith("libswtpu_native_") and len(path.stem) == 32
    assert not list((REPO / "swtpu_torch" / "runtime").glob("*.so"))
    # the same C++ below the head note, which names its own binding
    assert native._SRC.read_text().split("\n", 9)[-1] == (
        Path(ref_native._SRC).read_text().split("\n", 7)[-1])


def test_native_packer_bytes_equal_swtpu(monkeypatch):
    """pack_2bit, pack_wire, plan/fill streams, pack_bucket, and the FASTA
    index and encoder: the same bytes from both libraries (swtpu's built
    apart from its in-place build, which a parallel worker can race)."""
    lib = use_swtpu_native(monkeypatch)
    assert native.native_available() and ref_native.native_available()
    port, ref = native.NativePacker(), ref_native.NativePacker()
    assert ref._lib is lib
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=1001).astype(np.int8)
    np.testing.assert_array_equal(port.pack_2bit(codes), ref.pack_2bit(codes))
    packed = ref.pack_2bit(codes)
    np.testing.assert_array_equal(port.unpack_2bit(packed, 1001), ref.unpack_2bit(packed, 1001))
    stream = rng.integers(0, 13, size=(6, 64)).astype(np.int8)
    for a, b in zip(port.pack_wire(stream), ref.pack_wire(stream)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        port.pack_wire(stream[:, :12])
    lens = rng.integers(0, 50, size=300).astype(np.int32)
    mat = rng.integers(0, 4, size=(300, 50)).astype(np.int8)
    plan, ref_plan = port.plan_streams(lens, 16, 7), ref.plan_streams(lens, 16, 7)
    for a, b in zip(plan, ref_plan):
        np.testing.assert_array_equal(a, b)
    T = -(-(plan[2] + 7) // 32) * 32
    np.testing.assert_array_equal(
        port.fill_streams(mat, lens, plan[0], plan[1], 7, 8, T, 16, 4),
        ref.fill_streams(mat, lens, ref_plan[0], ref_plan[1], 7, 8, T, 16, 4))
    assign = (lens > 25).astype(np.int32)
    for a, b in zip(port.pack_bucket(mat, lens, assign, 1, 64, 4, 300),
                    ref.pack_bucket(mat, lens, assign, 1, 64, 4, 300)):
        np.testing.assert_array_equal(a, b)
    text = FASTA.encode()
    idx, ref_idx = port.index_fasta(text), ref.index_fasta(text)
    assert idx[0] == ref_idx[0]
    for a, b in zip(idx[1:], ref_idx[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.encode(text, idx[1], idx[2], 16, 4), ref.encode(text, idx[1], idx[2], 16, 4)):
        np.testing.assert_array_equal(a, b)


def test_event_log_lines_equal_swtpu(tmp_path):
    kw = dict(kind="batch", t_wall=1234.5, elapsed_s=0.25, reads=7, cells=1000,
              padded_cells=4096, note="bucket_len=128")
    logs = []
    for cls, ev, name in ((EventLog, BatchEvent, "port"), (RefEventLog, RefBatchEvent, "ref")):
        log = cls(tmp_path / f"{name}.jsonl")
        log.emit(ev(**kw))
        log.emit(ev("stream", 1.0, 0.0))
        log.close()
        logs.append((tmp_path / f"{name}.jsonl").read_bytes())
    assert logs[0] == logs[1]
    parsed = EventLog.parse(tmp_path / "port.jsonl")
    assert [dataclasses.asdict(e) for e in parsed] == [
        dataclasses.asdict(e) for e in RefEventLog.parse(tmp_path / "ref.jsonl")]
    assert parsed[0].gcups == RefBatchEvent(**kw).gcups
    assert EventLog().path is None


@pytest.mark.parametrize("name,score,ns", [("db1", 133, 0), ("query_x", 0, 123456789),
                                            ("a" * 20, 9999999, 5)])
def test_format_score_line_equals_swtpu(name, score, ns):
    assert format_score_line(name, score, ns) == ref_format_score_line(name, score, ns)
    assert format_score_line(name, np.int32(score), ns) == ref_format_score_line(name, score, ns)


def _port_files():
    files = sorted((REPO / "swtpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "experiments").glob("torch_*.py"))]
    return files


def test_no_port_file_imports_swtpu():
    """A static scan: `import swtpu...` or `from swtpu... import` (as
    opposed to swtpu_torch) anywhere in the port, chip_smoke.py or the
    port's experiments."""
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("swtpu", "jax", "jaxlib"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert len(_port_files()) > 20
    assert offenders == []


@pytest.mark.parametrize("module", ["bank/resume.py", "testing/faults.py",
                                    "testing/goldens.py", "testing/__init__.py",
                                    "utils/metrics.py", "bank/streams.py", "ops/scan.py",
                                    "parallel/mesh.py", "parallel/sharded.py",
                                    "parallel/multihost.py", "bank/serving.py",
                                    "testing/worker.py", "testing/regress.py",
                                    "testing/suite.py", "utils/guards.py", "bench.py",
                                    "bench_scaling.py"])
def test_scan_covers_the_job_modules(module):
    """The import scan reaches the job layer's modules (resume, faults,
    goldens, the profiler hook, score_streams) and the multi-device ones
    (the scan backend, the mesh, the sharded scorers, multihost, sharded
    serving, the worker and run_multihost, the checksum, the regression
    suites) and the benchmarks."""
    assert REPO / "swtpu_torch" / module in _port_files()


def test_fault_config_fields_equal_swtpu():
    from swtpu.testing.faults import FaultConfig as RefFaultConfig
    from swtpu_torch.testing.faults import FaultConfig

    assert _fields(FaultConfig) == _fields(RefFaultConfig)
    assert dataclasses.asdict(FaultConfig()) == dataclasses.asdict(RefFaultConfig())


@pytest.mark.parametrize("package", ["bank", "ops", "utils", "io", "parallel", "runtime",
                                     "testing"])
def test_subpackage_all_covers_swtpu(package):
    """Each subpackage's __all__ holds swtpu's names, and every name it
    lists is there (swtpu's Pallas entries as aliases of their
    counterparts)."""
    import importlib

    got = importlib.import_module(f"swtpu_torch.{package}")
    want = importlib.import_module(f"swtpu.{package}")
    assert set(want.__all__) <= set(got.__all__)
    for name in got.__all__:
        assert hasattr(got, name), name


def test_ops_aliases_and_stream_constants():
    import swtpu.bank.streams as ref_streams
    import swtpu_torch.ops as ops
    from swtpu_torch.bank import streams
    from swtpu_torch.ops.column import sw_scores_column
    from swtpu_torch.ops.lane import sw_scores_lane

    assert ops.sw_scores_pallas is sw_scores_column
    assert ops.sw_scores_pallas_lane is sw_scores_lane
    assert (ops.Q_PAD, ops.T_PAD) == (5, 4)
    assert streams.DRAIN == ref_streams.DRAIN == 127
    rng = np.random.default_rng(22)
    reads = [rng.integers(0, 4, size=k).astype(np.int8) for k in (0, 5, 40, 130)]
    query = rng.integers(0, 4, size=60).astype(np.int8)
    for kw in (dict(segments=1, rows=1), dict(segments=2, rows=4)):
        got = streams.pack_streams(query, reads, n_streams=8, **kw)
        want = ref_streams.pack_streams(query, reads, n_streams=8, **kw)
        assert got.total_steps == want.total_steps == got.stream.size
