"""The SSD scan's backward in the port against the JAX reference, on the CPU.

The reference trains its mamba block by differentiating the plain jnp
scan; the port's card path differentiates through a backward kernel
(``csrc/ssd_bwd.cu``) behind ``ops._SsdFn``. Here:

- the port's two plain backwards (``ref.ssd_bwd_ref``, autograd through
  ``ssd_reference``, and ``ref.ssd_backward_passes_ref``, the kernel's
  decomposition pass for pass) against ``jax.vjp`` of the reference's
  ``ssd_reference``, in f32 at the reference's shapes and a ragged S, with
  and without a final-state cotangent: within 1e-5 of each gradient's
  largest entry (the two sum in other orders; nothing is rounded to bf16);
- the tensor-core route's plain version (``ssd_backward_passes_ref`` with
  ``split_operands=True``: the operands that route computes in f32 as hi +
  lo bf16 pairs) against ``jax.vjp`` of the reference at the same shapes,
  on f32 inputs within 2e-3 and on bf16 inputs (x, B, C and dy) within
  2e-2 of each gradient's largest entry, the card's bands;
- ``ops._bwd_route``: which operands the backward's tensor-core route
  takes (bf16, aligned, widths and chunk it fits) and which go to the
  CUDA cores;
- the wiring of ``_SsdFn``: with the kernel's two entry points replaced
  by their plain versions inside the test, reduced mamba2's and zamba2's
  ``Model.loss`` gradients through ``_SsdFn`` equal those through plain
  autograd within 1e-5 of each leaf's largest entry. This catches a wrong
  argument order, a wrong ``None`` or a lost strided view, which the card
  alone would show;
- ``ssd()`` on CPU tensors is autograd through ``ssd_reference``, as it
  was before the backward kernel: the same tensors, the same ``grad_fn``.

Inputs come from numpy with fixed seeds; nothing reads a clock.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import Model, layers, materialize
from repro_torch.models.params import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {
    # b, s, h, p, n, chunk: the reference's (tests/test_kernels.py), then S
    # not a multiple of the chunk
    "2x32 chunk 8": (2, 32, 2, 8, 8, 8),
    "1x64 chunk 16": (1, 64, 4, 16, 16, 16),
    "2x128 chunk 32": (2, 128, 4, 32, 16, 32),
    "ragged 2x40 chunk 16": (2, 40, 4, 16, 16, 16),
}
PLAIN_BACKWARDS = {"ssd_bwd_ref": ref.ssd_bwd_ref,
                   "ssd_backward_passes_ref": ref.ssd_backward_passes_ref}
#: of each gradient's largest entry: both compute in f32, in other orders
RTOL = 1e-5


def inputs(seed, b, s, h, p, n, with_dfinal):
    """x, dt (after softplus), A (negative), B, C [b,s,1,n], dy and the
    final state's cotangent (or None), f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal((h,), dtype=np.float32))
    B = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    C = rng.standard_normal((b, s, 1, n), dtype=np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dfinal = rng.standard_normal((b, h, p, n), dtype=np.float32) if with_dfinal else None
    return (x, dt, A, B, C), dy, dfinal


@pytest.mark.parametrize("with_dfinal", [False, True], ids=["no dfinal", "dfinal"])
@pytest.mark.parametrize("which", list(PLAIN_BACKWARDS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backwards_match_jax_vjp_of_the_reference(shape, which, with_dfinal):
    b, s, h, p, n, chunk = SHAPES[shape]
    operands, dy, dfinal = inputs(7, b, s, h, p, n, with_dfinal)
    (_, final), vjp = jax.vjp(lambda *a: jref.ssd_reference(*a, chunk=chunk),
                              *map(jnp.asarray, operands))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal) if with_dfinal else jnp.zeros_like(final)))
    got = PLAIN_BACKWARDS[which](*map(torch.from_numpy, operands), torch.from_numpy(dy),
                                 None if dfinal is None else torch.from_numpy(dfinal),
                                 chunk=chunk)
    for g, w, t in zip(got, want, operands):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == t.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RTOL * np.abs(w).max())


#: the card's bands, of each gradient's largest entry
SPLIT_BANDS = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_dfinal", [False, True], ids=["no dfinal", "dfinal"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_operand_passes_match_jax_vjp_of_the_reference(shape, with_dfinal, dtype):
    """The tensor-core route's decomposition, its f32 operands split into
    hi + lo bf16 pairs where the kernel splits them, against the reference's
    gradient: x, B, C and dy in ``dtype`` (the reference gets their values
    in f32), dt and A f32."""
    b, s, h, p, n, chunk = SHAPES[shape]
    (x, dt, A, B, C), dy, dfinal = inputs(11, b, s, h, p, n, with_dfinal)
    x, B, C, dy = (torch.from_numpy(t).to(dtype) for t in (x, B, C, dy))
    dt, A = torch.from_numpy(dt), torch.from_numpy(A)
    operands = (x, dt, A, B, C)
    (_, final), vjp = jax.vjp(lambda *a: jref.ssd_reference(*a, chunk=chunk),
                              *(jnp.asarray(t.float().numpy()) for t in operands))
    want = vjp((jnp.asarray(dy.float().numpy()),
                jnp.asarray(dfinal) if with_dfinal else jnp.zeros_like(final)))
    got = ref.ssd_backward_passes_ref(*operands, dy,
                                      None if dfinal is None else torch.from_numpy(dfinal),
                                      chunk=chunk, split_operands=True)
    for g, w, t in zip(got, want, operands):
        w = np.asarray(w, np.float32)
        assert g.dtype == t.dtype and tuple(g.shape) == tuple(t.shape)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=SPLIT_BANDS[dtype] * np.abs(w).max())


def route_operands(P=64, N=128, dtype=torch.bfloat16, bc_dtype=None, offset=0):
    """x, dy, B and C of mamba2's layout on the CPU: x, B and C slices of one
    fused [1, 256, 2·P + 2·N + offset] tensor (``offset`` elements before
    B; B and C cast to ``bc_dtype`` if given), dy contiguous."""
    fused = torch.zeros((1, 256, 2 * P + 2 * N + offset), dtype=dtype)
    x = fused[..., :2 * P].view(1, 256, 2, P)
    B, C = fused[..., 2 * P + offset:2 * P + offset + N], fused[..., 2 * P + offset + N:]
    if bc_dtype is not None:
        B, C = B.to(bc_dtype), C.to(bc_dtype)
    return x, torch.zeros_like(x), B, C


@pytest.mark.parametrize("case,chunk,route", [
    (dict(), 128, "tensor_core"),
    (dict(N=64), 128, "tensor_core"),
    (dict(P=256, N=64), 64, "tensor_core"),
    (dict(dtype=torch.float32), 128, "cuda_core"),
    (dict(bc_dtype=torch.float32), 128, "cuda_core"),
    (dict(P=8), 128, "cuda_core"),
    (dict(), 32, "cuda_core"),
    (dict(offset=4), 128, "cuda_core"),
    (dict(P=256, N=256), 256, "cuda_core"),
], ids=["bf16 aligned", "zamba2 N=64", "P=256 chunk 64", "f32", "mixed", "P=8", "chunk 32",
        "unaligned slice", "P=N=256 chunk 256"])
def test_backward_route_from_dtypes_shapes_and_alignment(case, chunk, route):
    """The tensor cores take bf16 x, dy, B and C with 16-byte aligned rows,
    P and N multiples of 16 up to 256, a chunk that is a multiple of 64 up
    to 256, and a working set that fits a block's shared memory (not P = N
    = 256 at chunk 256); everything else takes the CUDA cores."""
    x, dy, B, C = route_operands(**case)
    assert ops._bwd_route(x, dy, B, C, chunk) == route


def f32_params(cfg) -> dict:
    params = materialize(Model(cfg).describe(), seed=0)
    return {k: f32_tree(v) for k, v in params.items()}


def f32_tree(t):
    return {k: f32_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.float()


def loss_grads(cfg, params, tokens):
    for _, t in flatten_tree(params):
        t.requires_grad_(True)
    loss, _ = Model(cfg, params).loss({"tokens": tokens})
    return loss, torch.autograd.grad(loss, [t for _, t in flatten_tree(params)])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_gradients_through_the_autograd_function_equal_plain_autograd(monkeypatch, arch):
    """Reduced ``Model.loss`` in f32: every leaf's gradient with the scan
    through ``_SsdFn`` (the kernel's entry points replaced by their plain
    versions: the forward's passes, the backward's passes) against the
    same model through autograd of ``ssd_reference``."""
    cfg = get_config(arch).reduced()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 41)))
    want_loss, want = loss_grads(cfg, f32_params(cfg), tokens)

    calls = {"forward": 0, "backward": 0, "dfinal": []}

    def forward(self, x, dt, A, Bm, Cm, *, chunk, route=None):
        calls["forward"] += 1
        return ref.ssd_chunked_passes_ref(x, dt, A, Bm, Cm, chunk=chunk)

    def backward(self, x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk):
        calls["backward"] += 1
        calls["dfinal"].append(dfinal)
        assert not x.is_contiguous() and not Bm.is_contiguous()   # the fused tensor's views
        return ref.ssd_backward_passes_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)

    def through_fn(x, dt, A, Bm, Cm, *, chunk=128):
        return ops._SsdFn.apply(x, dt, A, Bm, Cm, chunk)

    monkeypatch.setattr(ops.SsdKernel, "__call__", forward)
    monkeypatch.setattr(ops.SsdKernel, "backward", backward)
    monkeypatch.setattr(layers, "ssd", through_fn)
    loss, got = loss_grads(cfg, f32_params(cfg), tokens)
    mamba_layers = cfg.num_layers
    assert calls["forward"] == calls["backward"] == mamba_layers
    assert calls["dfinal"] == [None] * mamba_layers   # training uses no final state
    assert abs(loss.item() - want_loss.item()) <= RTOL * abs(want_loss.item())
    names = [n for n, _ in flatten_tree(f32_params(cfg))]
    for name, g, w in zip(names, got, want):
        scale = w.abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(g, w, rtol=0, atol=RTOL * scale, msg=name)


@pytest.mark.parametrize("groups", [3, 4], ids=["B [b,s,n]", "B [b,s,1,n]"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_ssd_is_autograd_through_ssd_reference(dtype, groups):
    """On CPU tensors ``ssd()`` returns what ``ssd_reference`` returns, bit
    for bit, under the same autograd node, and its gradients are that
    node's; no kernel counter moves."""
    (x, dt, A, B, C), dy, dfinal = inputs(9, 2, 40, 4, 16, 16, True)
    x, dy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    dt, A, dfinal = map(torch.from_numpy, (dt, A, dfinal))
    B, C = (torch.from_numpy(t).to(dtype) for t in (B, C))
    if groups == 3:
        B, C = B[:, :, 0], C[:, :, 0]
    counts = (ops.KERNEL.launches, ops.KERNEL.backward_launches)
    runs = []
    for fn in (lambda *a: ops.ssd(*a, chunk=16),
               lambda x, dt, A, B, C: ref.ssd_reference(
                   x, dt, A, *(t if t.dim() == 4 else t[:, :, None] for t in (B, C)),
                   chunk=16)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        y, final = fn(*leaves)
        grads = torch.autograd.grad((y, final), leaves, (dy, dfinal))
        runs.append((y, final, grads))
    (y, final, grads), (ry, rfinal, rgrads) = runs
    assert type(y.grad_fn) is type(ry.grad_fn)
    assert "SsdFn" not in type(y.grad_fn).__name__
    assert torch.equal(y, ry) and torch.equal(final, rfinal)
    for g, r in zip(grads, rgrads):
        assert torch.equal(g, r)
    assert (ops.KERNEL.launches, ops.KERNEL.backward_launches) == counts
