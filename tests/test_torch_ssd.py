"""The port's Mamba-2 SSD scan against the JAX reference.

The port's plain versions (``repro_torch.kernels.ssd.ref``: the chunked
``ssd_reference``, ``ssd_decode_step`` and the sequential ``ssd_naive``)
are held against the reference's jnp oracles on the same numpy inputs,
and the port's wrapper on CPU tensors (``ops.ssd``, which takes
``ssd_reference`` there) against the Pallas kernel in interpret mode.
Bands are the reference's own (``tests/test_kernels.py``): ``tol()`` for y
(2e-3 in f32, 2e-2 in bf16, where the frameworks round the bf16 output of
an f32 computation that sums in another order), 1e-2 for the final state,
2e-3 against the naive scan and 5e-3 for chunk invariance.

The CUDA kernel itself runs only on a card: ``test_kernel_matches_plain_on_card``
is marked ``cuda`` and skips where there is none.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jref
from repro.kernels.ssd.kernel import ssd as pallas_ssd
from repro_torch.kernels.ssd import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSD_SHAPES = [
    # b, s, h, p, n, chunk (tests/test_kernels.py)
    (2, 32, 2, 8, 8, 8),
    (1, 64, 4, 16, 16, 16),
    (2, 128, 4, 32, 16, 32),
]
#: S not a multiple of the chunk: the padded tail
RAGGED_SHAPE = (2, 40, 4, 16, 16, 16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STATE_BAND = 1e-2

JAX_REF = jax.jit(jref.ssd_reference, static_argnames=("chunk",))


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def make_inputs(seed, b, s, h, p, n):
    """x, dt (after softplus), A (negative), B, C [b,s,1,n] as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal((h,), dtype=np.float32))
    B = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    C = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    return x, dt, A, B, C


def as_jax(arrs, x_dtype):
    x, dt, A, B, C = arrs
    return jnp.asarray(x, x_dtype), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)


def as_torch(arrs, x_dtype):
    x, dt, A, B, C = arrs
    return (torch.from_numpy(x).to(x_dtype), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(B), torch.from_numpy(C))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES + [RAGGED_SHAPE])
def test_ssd_reference_matches_jax(shape, dtype):
    jd, td = DTYPES[dtype]
    *dims, chunk = shape
    arrs = make_inputs(1, *dims)
    yj, sj = JAX_REF(*as_jax(arrs, jd), chunk=chunk)
    yt, st = ref.ssd_reference(*as_torch(arrs, td), chunk=chunk)
    assert yt.dtype == td and st.dtype == torch.float32
    assert tuple(yt.shape) == tuple(yj.shape) and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_allclose(f32(yt), f32(yj), **tol(dtype))
    np.testing.assert_allclose(f32(st), f32(sj), rtol=STATE_BAND, atol=STATE_BAND)


def test_ssd_reference_initial_state_matches_jax():
    b, s, h, p, n, chunk = SSD_SHAPES[1]
    arrs = make_inputs(2, b, s, h, p, n)
    init = np.random.default_rng(3).standard_normal((b, h, p, n), dtype=np.float32)
    yj, sj = JAX_REF(*as_jax(arrs, jnp.float32), chunk=chunk, initial_state=jnp.asarray(init))
    yt, st = ref.ssd_reference(*as_torch(arrs, torch.float32), chunk=chunk,
                               initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(f32(yt), f32(yj), **tol("float32"))
    np.testing.assert_allclose(f32(st), f32(sj), rtol=STATE_BAND, atol=STATE_BAND)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_step_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, h, p, n = 2, 4, 16, 8
    state = rng.standard_normal((b, h, p, n), dtype=np.float32)
    x = rng.standard_normal((b, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal((h,), dtype=np.float32))
    B = rng.standard_normal((b, 1, n), dtype=np.float32)
    C = rng.standard_normal((b, 1, n), dtype=np.float32)
    yj, sj = jref.ssd_decode_step(jnp.asarray(state), jnp.asarray(x, jd), jnp.asarray(dt),
                                  jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    yt, st = ref.ssd_decode_step(torch.from_numpy(state), torch.from_numpy(x).to(td),
                                 torch.from_numpy(dt), torch.from_numpy(A),
                                 torch.from_numpy(B), torch.from_numpy(C))
    assert yt.dtype == td
    np.testing.assert_allclose(f32(yt), f32(yj), **tol(dtype))
    np.testing.assert_allclose(f32(st), f32(sj), rtol=2e-3, atol=2e-3)


def test_ssd_naive_matches_jax_and_the_chunked_scan():
    """The port's sequential scan equals the reference's, and the port's
    chunked decomposition equals its own sequential recurrence."""
    arrs = make_inputs(5, 1, 24, 2, 4, 8)
    yj, sj = jref.ssd_naive(*as_jax(arrs, jnp.float32))
    yn, sn = ref.ssd_naive(*as_torch(arrs, torch.float32))
    np.testing.assert_allclose(f32(yn), f32(yj), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(f32(sn), f32(sj), rtol=2e-3, atol=2e-3)
    yr, sr = ref.ssd_reference(*as_torch(arrs, torch.float32), chunk=8)
    np.testing.assert_allclose(f32(yr), f32(yn), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(f32(sr), f32(sn), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ops_ssd_on_cpu_matches_pallas_interpret(shape, dtype):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode (B/C as [b,s,n], the kernel's own form)."""
    jd, td = DTYPES[dtype]
    *dims, chunk = shape
    arrs = make_inputs(6, *dims)
    x, dt, A, B, C = as_jax(arrs, jd)
    yk, sk = pallas_ssd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk, interpret=True)
    x, dt, A, B, C = as_torch(arrs, td)
    before = ops.KERNEL.launches
    yt, st = ops.ssd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk)
    assert ops.KERNEL.launches == before          # CPU tensors take the plain version
    np.testing.assert_allclose(f32(yt), f32(yk), **tol(dtype))
    np.testing.assert_allclose(f32(st), f32(sk), rtol=STATE_BAND, atol=STATE_BAND)


def test_ops_ssd_takes_ragged_s_and_both_ranks():
    """The wrapper pads a ragged S as the reference does (the Pallas
    kernel asserts S % chunk == 0), and takes B/C as [b,s,1,n] or [b,s,n]."""
    *dims, chunk = RAGGED_SHAPE
    arrs = make_inputs(7, *dims)
    yj, sj = JAX_REF(*as_jax(arrs, jnp.bfloat16), chunk=chunk)
    x, dt, A, B, C = as_torch(arrs, torch.bfloat16)
    y4, s4 = ops.ssd(x, dt, A, B, C, chunk=chunk)
    y3, s3 = ops.ssd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk)
    np.testing.assert_array_equal(f32(y4), f32(y3))
    np.testing.assert_array_equal(f32(s4), f32(s3))
    np.testing.assert_allclose(f32(y4), f32(yj), **tol("bfloat16"))
    np.testing.assert_allclose(f32(s4), f32(sj), rtol=STATE_BAND, atol=STATE_BAND)
    with pytest.raises(ValueError, match="single"):
        ops.ssd(x, dt, A, B.expand(-1, -1, 2, -1), C.expand(-1, -1, 2, -1), chunk=chunk)


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 8), (2, 16), (3, 4), (4, 8)])
def test_ssd_chunk_invariance(seed, chunk):
    """The port's result is independent of the chunking factor, as the
    reference's is (tests/test_kernels.py's property)."""
    arrs = make_inputs(seed, 1, 32, 2, 8, 4)
    t = as_torch(arrs, torch.float32)
    y1, s1 = ref.ssd_reference(*t, chunk=chunk)
    y2, s2 = ref.ssd_reference(*t, chunk=32)
    np.testing.assert_allclose(f32(y1), f32(y2), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(f32(s1), f32(s2), rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, td = DTYPES[dtype]
    # the serving path's shape: 80 heads of 64, state 128, a ragged S
    arrs = make_inputs(8, 1, 200, 80, 64, 128)
    x, dt, A, B, C = (t.cuda() for t in as_torch(arrs, td))
    B, C = B.to(td), C.to(td)
    before = ops.KERNEL.launches
    y, st = ops.ssd(x, dt, A, B, C, chunk=128)
    torch.cuda.synchronize()
    assert ops.KERNEL.launches == before + 1
    yr, sr = ref.ssd_reference(x, dt, A, B, C, chunk=128)
    torch.testing.assert_close(y.float(), yr.float(), **tol(dtype))
    torch.testing.assert_close(st, sr, rtol=STATE_BAND, atol=STATE_BAND)
