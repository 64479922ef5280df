"""The microbenchmarks' plain versions (E1 and E2) against the TPU kernels
of experiments/microbench_ops.py and experiments/kernel_ablate.py, run
through pl.pallas_call in interpret mode, and E2's full strip against the
wavefront's plain version.  Every value is a small integer: bit-equal in
all four types.  The CUDA kernels' own tests are in test_torch_cuda.py."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from swtpu_torch.config import DEFAULT_PENALTIES
from swtpu_torch.ops import microbench
from swtpu_torch.ops.stream import stream_strip_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JNP = {"int32": jnp.int32, "int16": jnp.int16, "float32": jnp.float32,
       "bfloat16": jnp.bfloat16}
# kernel_ablate.py sets these two JAX options when it is imported
CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load(name):
    """An experiments/ script as a module, restoring the JAX options and
    sys.path it changes on import (other tests share the process)."""
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_ref_{name}", REPO / "experiments" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def e1():
    return _load("microbench_ops")


@pytest.fixture(scope="module")
def e2():
    return _load("kernel_ablate")


def test_loading_kernel_ablate_leaves_jax_options():
    before = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    mod = _load("kernel_ablate")
    assert callable(mod.make_kernel)
    assert {k: getattr(jax.config, k) for k in CACHE_OPTIONS} == before


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("pattern", microbench.PATTERNS)
@pytest.mark.parametrize("dtype", list(microbench.DTYPES))
def test_microbench_ops_equals_interpret_kernel(e1, dtype, pattern):
    steps = 3
    x = np.random.default_rng(0).integers(0, 5, microbench.SHAPE)
    f = pl.pallas_call(
        e1.make_kernel(pattern, JNP[dtype], steps),
        out_shape=jax.ShapeDtypeStruct(microbench.SHAPE, JNP[dtype]),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(x, JNP[dtype])).astype(jnp.float32))
    got = microbench.microbench_ops_reference(
        _torch(x, microbench.DTYPES[dtype]), pattern, steps)
    assert got.dtype == microbench.DTYPES[dtype] and tuple(got.shape) == microbench.SHAPE
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert 0 <= got.float().min() and got.float().max() <= 6


def _ablate_interpret(e2, variant, dtype, qT, stream):
    """kernel_ablate.run_variant's pallas_call in interpret mode, at 8
    steps a grid step instead of 32 (the kernel unrolls a block's steps;
    its state carries across grid steps, so the strip is the same and the
    interpret build is 4x smaller)."""
    S = qT.shape[1]
    T = stream.shape[0]
    chunk = 8
    f = pl.pallas_call(
        e2.make_kernel(variant, JNP[dtype]),
        grid=(T // chunk,),
        in_specs=[
            pl.BlockSpec((e2.LANES, S), lambda c: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, S), lambda c: (c, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((chunk, S), lambda c: (c, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T, S), jnp.int32),
        scratch_shapes=[pltpu.VMEM((e2.LANES, S), JNP[dtype]) for _ in range(4)]
        + [pltpu.VMEM((e2.LANES, S), jnp.int32), pltpu.VMEM((8, S), JNP[dtype])],
        interpret=True,
    )
    return np.asarray(f(qT, stream))


def _ablate_inputs(seed, T, S=128, flags=False):
    rng = np.random.default_rng(seed)
    qT = rng.integers(0, 4, (microbench.LANES, S)).astype(np.int8)
    stream = rng.integers(0, 4, (T, S)).astype(np.int8)
    if flags:  # read starts: the boundary selects' f0
        stream[rng.random((T, S)) < 0.02] |= 8
    return qT, stream


CASES = [(v, "int32") for v in microbench.VARIANTS] + [
    (v, d) for v in ("full", "arith") for d in ("int16", "float32", "bfloat16")
]


@pytest.mark.parametrize("variant,dtype", CASES)
def test_stream_ablate_equals_interpret_kernel(e2, variant, dtype):
    T = 160 + 32 * (CASES.index((variant, dtype)) % 3)  # 160-224 steps
    qT, stream = _ablate_inputs(len(variant), T, flags=True)
    want = _ablate_interpret(e2, variant, dtype, qT, stream)
    got = microbench.stream_ablate_reference(
        torch.from_numpy(qT), torch.from_numpy(stream), variant,
        microbench.DTYPES[dtype])
    assert got.dtype == torch.int32 and tuple(got.shape) == (T, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flags", [False, True])
def test_stream_ablate_full_is_the_wavefront(flags):
    """E2's full int32 strip is B2's: stream_strip_reference at rows 1,
    segments 1, on the same kernel-layout inputs."""
    qT, stream = _ablate_inputs(7, 256, flags=flags)
    q, s = torch.from_numpy(qT), torch.from_numpy(stream)
    got = microbench.stream_ablate_reference(q, s, "full")
    want = stream_strip_reference(q, s, DEFAULT_PENALTIES, segments=1, rows=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_entries_reject_bad_arguments():
    x = torch.zeros(microbench.SHAPE, dtype=torch.int64)
    with pytest.raises(ValueError, match="dtype torch.int64"):
        microbench.microbench_ops_reference(x, "addmax", 1)
    with pytest.raises(ValueError, match="unknown pattern"):
        microbench.microbench_ops_reference(x.int(), "roll", 1)
    q = torch.zeros((128, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="unknown variant"):
        microbench.stream_ablate_reference(q, q[:32], "nothing")
    with pytest.raises(ValueError, match="no microbench kernel"):
        microbench.microbench_ops(x.int().to("meta"), "addmax", 1)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On the CPU the dispatchers take the plain versions; the CUDA
    wrappers refuse a CPU tensor before anything launches."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    x = torch.zeros(microbench.SHAPE, dtype=torch.int32)
    q = torch.zeros((128, 8), dtype=torch.int8)
    e1_cuda, e2_cuda = microbench.microbench_ops_cuda, microbench.stream_ablate_cuda
    launches = (e1_cuda.launches, e2_cuda.launches)
    with pytest.raises(ValueError, match="CUDA int32 tensor"):
        e1_cuda(x, "addmax", 1)
    with pytest.raises(ValueError, match="CUDA int8 tensor"):
        e2_cuda(q, q[:32], "full")
    monkeypatch.setattr(microbench, "microbench_ops_cuda", refuse)
    monkeypatch.setattr(microbench, "stream_ablate_cuda", refuse)
    assert microbench.microbench_ops(x, "select", 2).shape == x.shape
    assert microbench.stream_ablate(q, q[:32], "full").shape == (32, 8)
    assert (e1_cuda.launches, e2_cuda.launches) == launches
