"""The SSD scan's tensor-core decomposition, on the CPU.

``ref.ssd_chunked_passes_ref`` runs the three passes of the Hopper kernel's
tensor-core route (chunk states, the state recurrence, the outputs) in
plain PyTorch, with the f32 operands the kernel splits into hi + lo bf16
pairs split the same way when asked. It is held against the JAX package's
``ssd_reference``, ``ssd_naive`` and the Pallas kernel in interpret mode on
the same numpy inputs, at the reference's shapes, a ragged S, S below the
chunk and S = 1. Bands are the reference's own (``tests/test_kernels.py``):
y 2e-3 in f32 and 2e-2 in bf16, the final state 1e-2.

The grid plan (``ops._scan_plan``) is checked here too: its output blocks
cover every (row, chunk, head, row tile, column range) exactly once, and
it fills 132 SMs at mamba2's shape for a one-chunk and a two-chunk
prefill. The kernel itself is held against this plain version on the card
(``tests/test_torch_kernels_on_card.py``).
"""
from __future__ import annotations

import itertools

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


SHAPES = {
    # name -> b, s, h, p, n, chunk; the first three are tests/test_kernels.py's
    "ref 32/8": (2, 32, 2, 8, 8, 8),
    "ref 64/16": (1, 64, 4, 16, 16, 16),
    "ref 128/32": (2, 128, 4, 32, 16, 32),
    "ragged 40/16": (2, 40, 4, 16, 16, 16),
    "below chunk 11/16": (1, 11, 2, 16, 16, 16),
    "S=1": (2, 1, 2, 16, 16, 16),
}
#: the shapes the Pallas kernel takes (S a multiple of the chunk)
PALLAS_SHAPES = ["ref 32/8", "ref 64/16", "ref 128/32"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STATE_BAND = dict(rtol=1e-2, atol=1e-2)
JAX_REF = jax.jit(jref.ssd_reference, static_argnames=("chunk",))


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def make_inputs(seed, b, s, h, p, n, dtype):
    """x, dt (after softplus), A (negative), B, C [b,s,1,n] as f32 numpy;
    x, B and C already hold values of ``dtype`` (the kernel's bf16 route
    takes bf16 B/C, and both frameworks then start from the same values)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal((h,), dtype=np.float32))
    B = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    C = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    if dtype == "bfloat16":
        x, B, C = (torch.from_numpy(t).to(torch.bfloat16).float().numpy() for t in (x, B, C))
    return x, dt, A, B, C


def as_jax(arrs, dtype):
    x, dt, A, B, C = arrs
    return jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)


def as_torch(arrs, dtype):
    x, dt, A, B, C = arrs
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(B).to(dtype), torch.from_numpy(C).to(dtype))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("split", [False, True], ids=["f32 operands", "split operands"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_passes_match_jax_reference(name, dtype, split):
    jd, td = DTYPES[dtype]
    *dims, chunk = SHAPES[name]
    arrs = make_inputs(1, *dims, dtype)
    yj, sj = JAX_REF(*as_jax(arrs, jd), chunk=chunk)
    yt, st = ref.ssd_chunked_passes_ref(*as_torch(arrs, td), chunk=chunk, split_operands=split)
    assert yt.dtype == td and st.dtype == torch.float32
    assert tuple(yt.shape) == tuple(yj.shape) and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_allclose(f32(yt), f32(yj), **tol(dtype))
    np.testing.assert_allclose(f32(st), f32(sj), **STATE_BAND)


@pytest.mark.parametrize("split", [False, True], ids=["f32 operands", "split operands"])
@pytest.mark.parametrize("name", ["ragged 40/16", "below chunk 11/16", "S=1"])
def test_passes_match_jax_sequential_scan(name, split):
    """Against the reference's O(s) recurrence, which knows no chunks."""
    *dims, chunk = SHAPES[name]
    arrs = make_inputs(2, *dims, "float32")
    yn, sn = jref.ssd_naive(*as_jax(arrs, jnp.float32))
    yt, st = ref.ssd_chunked_passes_ref(*as_torch(arrs, torch.float32), chunk=chunk,
                                        split_operands=split)
    np.testing.assert_allclose(f32(yt), f32(yn), **tol("float32"))
    np.testing.assert_allclose(f32(st), f32(sn), **tol("float32"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", PALLAS_SHAPES)
def test_split_passes_match_pallas_interpret(name, dtype):
    """Against the Pallas kernel in interpret mode (B/C as [b,s,n])."""
    jd, td = DTYPES[dtype]
    *dims, chunk = SHAPES[name]
    arrs = make_inputs(3, *dims, dtype)
    x, dt, A, B, C = as_jax(arrs, jd)
    yk, sk = pallas_ssd(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk, interpret=True)
    x, dt, A, B, C = as_torch(arrs, td)
    yt, st = ref.ssd_chunked_passes_ref(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=chunk,
                                        split_operands=True)
    np.testing.assert_allclose(f32(yt), f32(yk), **tol(dtype))
    np.testing.assert_allclose(f32(st), f32(sk), **STATE_BAND)


def test_split_operands_keep_about_sixteen_bits():
    """hi + lo carries a value to ~2**-16 of itself, where one bf16
    rounding carries it to 2**-8."""
    t = torch.from_numpy(np.random.default_rng(4).standard_normal(4096, dtype=np.float32))
    split_err = ((ref._split_bf16(t) - t).abs() / t.abs()).max().item()
    one_err = ((t.to(torch.bfloat16).float() - t).abs() / t.abs()).max().item()
    assert split_err <= 2.0 ** -16 < 2.0 ** -10 <= one_err <= 2.0 ** -8


#: (B, S, H, P, N, chunk): mamba2's scan and narrower ones, ragged and short
PLAN_SHAPES = [
    (1, 1, 80, 64, 128, 128),
    (1, 77, 80, 64, 128, 128),
    (1, 128, 80, 64, 128, 128),
    (1, 200, 80, 64, 128, 128),
    (1, 256, 80, 64, 128, 128),
    (2, 300, 80, 64, 128, 256),
    (1, 200, 80, 64, 128, 64),
    (2, 45, 4, 32, 64, 64),
    (1, 190, 3, 128, 16, 128),
]


def output_blocks(plan, Bsz, S, H, P, Q):
    """The output pass's live blocks as ``ssd_tc_output_kernel`` decodes
    its grid ``(row_tiles * p_splits, H, Bsz * chunks)`` (blocks whose row
    tile starts past S exit): ``(b, chunk, head, first row of the tile in
    the chunk, first column of P, columns)``."""
    width = P // plan.p_splits
    for z in range(Bsz * plan.chunks):
        b, c = divmod(z, plan.chunks)
        for h in range(H):
            for bx in range(plan.row_tiles * plan.p_splits):
                tile, ps = divmod(bx, plan.p_splits)
                if c * Q + tile * ops.ROW_TILE < S:
                    yield b, c, h, tile * ops.ROW_TILE, ps * width, width


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_output_blocks_cover_every_tile_once(shape):
    Bsz, S, H, P, N, Q = shape
    plan = ops._scan_plan(Bsz, S, H, P, N, Q, 132)
    blocks = list(output_blocks(plan, Bsz, S, H, P, Q))
    assert len(blocks) == plan.output_blocks
    width = P // plan.p_splits
    assert width % 16 == 0 and width <= 64 and N % (16 * plan.state_splits) == 0
    assert plan.chunks == -(-S // Q) and plan.row_tiles * ops.ROW_TILE == Q
    # every (row, chunk, head, live row tile, column of P) once
    cells = [(b, c, h, i0, p) for b, c, h, i0, p0, w in blocks for p in range(p0, p0 + w)]
    want = [(b, c, h, i0, p)
            for b, c, h, i0, p in itertools.product(range(Bsz), range(plan.chunks), range(H),
                                                    range(0, Q, ops.ROW_TILE), range(P))
            if c * Q + i0 < S]
    assert sorted(cells) == want


@pytest.mark.parametrize("S", [1, 77, 128, 200, 256])
def test_plan_fills_the_card_at_mamba2s_shape(S):
    """At least one block for each of an H100's 132 SMs in both parallel
    passes, for one-chunk prefills (S <= 128) too."""
    plan = ops._scan_plan(1, S, 80, 64, 128, 128, 132)
    assert plan.state_blocks >= 132 and plan.output_blocks >= 132


def test_plan_reads_only_host_integers():
    """The plan is a function of shapes and the SM count: the same numbers
    give the same plan, and a wider card needs no more splits."""
    a = ops._scan_plan(1, 128, 80, 64, 128, 128, 132)
    assert a == ops._scan_plan(1, 128, 80, 64, 128, 128, 132)
    b = ops._scan_plan(1, 128, 80, 64, 128, 128, 66)
    assert b.state_splits <= a.state_splits and b.p_splits <= a.p_splits


@pytest.mark.parametrize("case,route", [
    ("bf16 mamba2", "tensor_core"),
    ("bf16 fused slices", "tensor_core"),
    ("f32", "cuda_core"),
    ("bf16 x, f32 B/C", "cuda_core"),
    ("P not a multiple of 16", "cuda_core"),
    ("chunk 32", "cuda_core"),
    ("chunk 512", "cuda_core"),
    ("unaligned rows", "cuda_core"),
])
def test_route_is_chosen_by_dtype_and_shape(case, route):
    bf16, f32_ = torch.bfloat16, torch.float32
    b, s, h, p, n, q = 1, 200, 80, 64, 128, 128
    x_dtype, bc_dtype = (f32_, f32_) if case == "f32" else (bf16, bf16)
    if case == "bf16 x, f32 B/C":
        bc_dtype = f32_
    if case == "P not a multiple of 16":
        p = 40
    if case in ("chunk 32", "chunk 512"):
        q = int(case.split()[1])
    x = torch.zeros((b, s, h, p), dtype=x_dtype)
    B, C = (torch.zeros((b, s, n), dtype=bc_dtype) for _ in range(2))
    if case == "bf16 fused slices":
        xbc = torch.zeros((b, s, h * p + 2 * n), dtype=bf16)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    if case == "unaligned rows":
        x = torch.zeros((b, s, h, p + 1), dtype=bf16)[..., :p]   # rows 65 elements apart
    chosen, plan = ops._route(x, B, C, q, 132)
    assert chosen == route
    assert (plan is not None) == (route == "tensor_core")
