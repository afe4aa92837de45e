"""Plain PyTorch version of the Mamba-2 SSD (state-space duality) scan.

The counterpart of ``repro/kernels/ssd/ref.py``: the chunked block
decomposition of Dao & Gu, "Transformers are SSMs" (arXiv:2405.21060,
Algorithm 1): a within-chunk attention-like term plus a between-chunk
low-rank state recurrence. The model runs it on CPU tensors, and the
Hopper kernel (``csrc/ssd.cu``) is held against it on the card. The whole
computation is in f32; ``y`` comes back in ``x``'s dtype.

Shapes (h = heads, p = head dim, n = state dim, g = B/C groups):
    x  : [b, s, h, p]
    dt : [b, s, h]       (post-softplus, >= 0)
    A  : [h]             (negative reals; decay = exp(dt * A))
    B  : [b, s, g, n]
    C  : [b, s, g, n]
returns
    y          : [b, s, h, p]
    final_state: [b, h, p, n] f32
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def _expand_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """[b, s, g, n] -> [b, s, h, n] by repeating each group over its heads."""
    g = t.shape[2]
    if h % g:
        raise ValueError(f"{h} heads do not divide into {g} groups")
    return torch.repeat_interleave(t, h // g, dim=2)


def ssd_reference(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        # zero-pad to a chunk multiple: dt=0 -> decay 1, x=0 -> no update
        pad = chunk - s % chunk
        y, st = ssd_reference(
            F.pad(x, (0, 0, 0, 0, 0, pad)),
            F.pad(dt, (0, 0, 0, pad)),
            A,
            F.pad(B, (0, 0, 0, 0, 0, pad)),
            F.pad(C, (0, 0, 0, 0, 0, pad)),
            chunk=chunk,
            initial_state=initial_state,
        )
        return y[:, :s], st
    c = s // chunk
    dev = x.device

    Bh = _expand_groups(B, h).to(F32)
    Ch = _expand_groups(C, h).to(F32)
    xf = x.to(F32)
    dtf = dt.to(F32)
    dA = dtf * A.to(F32)[None, None, :]                         # [b,s,h]

    # chunked views
    xq = xf.reshape(b, c, chunk, h, p)
    dtq = dtf.reshape(b, c, chunk, h)
    dAq = dA.reshape(b, c, chunk, h)
    Bq = Bh.reshape(b, c, chunk, h, n)
    Cq = Ch.reshape(b, c, chunk, h, n)

    cum = torch.cumsum(dAq, dim=2)                              # [b,c,q,h]
    total = cum[:, :, -1, :]                                    # [b,c,h]

    # ---- intra-chunk (the "attention-like" quadratic term)
    # L[i,j] = exp(cum_i - cum_j) for i >= j else 0
    li = cum[:, :, :, None, :]                                  # [b,c,q,1,h]
    lj = cum[:, :, None, :, :]                                  # [b,c,1,q,h]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    L = torch.where(mask[None, None, :, :, None], torch.exp(li - lj), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cq, Bq) * L     # [b,c,q,k,h]
    xdt = xq * dtq[..., None]                                   # [b,c,q,h,p]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    # ---- per-chunk states: sum_k exp(total - cum_k) * B_k (x)dt_k
    decay_to_end = torch.exp(total[:, :, None, :] - cum)        # [b,c,q,h]
    chunk_states = torch.einsum(
        "bcqhn,bcqhp->bchpn", Bq * decay_to_end[..., None], xdt
    )                                                           # [b,c,h,p,n]

    # ---- inter-chunk recurrence over chunk states (the reference's scan)
    decay_chunk = torch.exp(total)                              # [b,c,h]
    carry = (torch.zeros((b, h, p, n), dtype=F32, device=dev)
             if initial_state is None else initial_state.to(F32))
    prev = []
    for ci in range(c):
        prev.append(carry)                                      # state BEFORE chunk
        carry = carry * decay_chunk[:, ci, :, None, None] + chunk_states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # [b,c,h,p,n]

    # ---- inter-chunk contribution: C_q exp(cum_q) @ state_before_chunk
    y_off = torch.einsum(
        "bcqhn,bchpn->bcqhp", Cq * torch.exp(cum)[..., None], prev_states
    )

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrent update: h' = exp(dt*A) h + dt * x (x) B; y = C h'.

    state [b, h, p, n] f32; x [b, h, p]; dt [b, h]; A [h]; B/C [b, g, n].
    """
    b, h, p, n = state.shape
    Bh = torch.repeat_interleave(B, h // B.shape[1], dim=1).to(F32)   # [b,h,n]
    Ch = torch.repeat_interleave(C, h // C.shape[1], dim=1).to(F32)
    decay = torch.exp(dt.to(F32) * A.to(F32)[None, :])                # [b,h]
    upd = (dt.to(F32)[..., None] * x.to(F32))[..., None] * Bh[:, :, None, :]
    new_state = state * decay[:, :, None, None] + upd                 # [b,h,p,n]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


def ssd_naive(x, dt, A, B, C, *, initial_state=None):
    """O(s) sequential scan: the ground-truth oracle for tiny shapes."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
             if initial_state is None else initial_state.to(F32))
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _split_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the sum of two bf16 values, hi = bf16(t) and lo = bf16(t - hi),
    back in f32: the tensor-core kernel's form of an operand it computes in
    f32 (about 16 bits of mantissa instead of bf16's 8)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_chunked_passes_ref(x, dt, A, B, C, *, chunk: int = 128, split_operands: bool = False):
    """The tensor-core kernel's decomposition of the scan in plain PyTorch:
    the same three passes, for a single B/C group (``[b, s, n]`` or
    ``[b, s, 1, n]``), with y in x's dtype and the final state f32.

    1. chunk pass: ``cum`` = prefix sum of dt·A within each chunk, and the
       chunk's state ``xᵀ·(B ∘ dt·exp(total - cum))``;
    2. state pass: ``carry = carry·exp(total_c) + state_c`` over the chunks,
       the running state after each chunk but the last, and the final state;
    3. output pass: ``y = (C·Bᵀ ∘ L ∘ dt_j)·x + exp(cum) ∘ (C·stateᵀ)``, the
       second term only for chunks after the first (whose state is zero).

    With ``split_operands`` the three operands the kernel computes in f32
    (``B ∘ dt·exp(total - cum)``, ``C·Bᵀ ∘ L ∘ dt_j`` and the carried state)
    become hi + lo bf16 pairs (``_split_bf16``), as the kernel feeds them
    to its bf16 products; x, B and C are taken as they come. Positions past
    ``s`` are zero, as the kernel's masked loads read them."""
    if B.dim() == 4:
        B, C = B[:, :, 0], C[:, :, 0]
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    op = _split_bf16 if split_operands else (lambda t: t)
    xq = F.pad(x.to(F32), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dtq = F.pad(dt.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    Bq = F.pad(B.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    Cq = F.pad(C.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)

    # pass 1: cum, the chunk's total, the chunk states
    cum = torch.cumsum(dtq * A.to(F32), dim=2)                         # [b,c,q,h]
    total = cum[:, :, -1]                                              # [b,c,h]
    w = dtq * torch.exp(total[:, :, None] - cum)                       # [b,c,q,h]
    Bw = op(Bq[:, :, :, None, :] * w[..., None])                       # [b,c,q,h,n]
    states = torch.einsum("bcqhp,bcqhn->bchpn", xq, Bw)

    # pass 2: the running state after each chunk; the last one is final
    carry = states[:, 0]
    after = [carry]
    for ci in range(1, nc):
        carry = carry * torch.exp(total[:, ci])[..., None, None] + states[:, ci]
        after.append(carry)

    # pass 3: the causal intra-chunk term, then the carried state's
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    L = torch.where(causal, torch.exp(cum[:, :, :, None] - cum[:, :, None, :]), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cq, Bq)[..., None]       # [b,c,i,j,1]
    coef = op(scores * (L * dtq[:, :, None, :, :]))                    # [b,c,i,j,h]
    y = torch.einsum("bcijh,bcjhp->bcihp", coef, xq)
    if nc > 1:
        prev = op(torch.stack(after[:-1], dim=1))                      # [b,c-1,h,p,n]
        y_off = torch.einsum("bcin,bchpn->bcihp", Cq[:, 1:], prev)
        y_off = y_off * torch.exp(cum[:, 1:])[..., None]
        y = torch.cat([y[:, :1], y[:, 1:] + y_off], dim=1)
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), carry


def ssd_bwd_ref(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 128):
    """dx, ddt, dA, dB, dC (f32) of :func:`ssd_reference` on the operands
    cast to f32, for the output gradient ``dy`` and the final state's
    ``dfinal`` (None: the final state is not used): ``torch.autograd.grad``
    through the plain forward. B and C are one group, ``[b, s, n]`` or
    ``[b, s, 1, n]``; dB and dC come back in the shape given."""
    with torch.enable_grad():
        leaves = [t.detach().to(F32).requires_grad_(True) for t in (x, dt, A, B, C)]
        B4, C4 = (t if t.dim() == 4 else t[:, :, None] for t in leaves[3:])
        y, final = ssd_reference(*leaves[:3], B4, C4, chunk=chunk)
        outs, grads = [y], [dy.to(F32)]
        if dfinal is not None:
            outs.append(final)
            grads.append(dfinal.to(F32))
        return torch.autograd.grad(outs, leaves, grads)


def ssd_backward_passes_ref(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 128,
                            carry_gradient: bool = True, carry_state: bool = True,
                            decay_gradient: bool = True, causal: bool = True,
                            split_operands: bool = False):
    """The backward kernel's decomposition of the scan's gradient
    (``csrc/ssd_bwd.cu``) in plain PyTorch, pass for pass, for a single B/C
    group: dx in x's dtype, ddt and dA f32, dB and dC in B's dtype.

    With ``a = dt·A``, ``cum`` its prefix sum within a chunk, ``T`` the
    chunk's total, ``u = dt·x`` and ``L_ij = exp(cum_i - cum_j)`` (j <= i):

    1. chunk pass: each chunk's state ``Σ_j exp(T - cum_j) u_j ⊗ B_j`` and
       its share of the state's gradient ``Σ_i exp(cum_i) dy_i ⊗ C_i``;
    2. state pass: the state before each chunk (``h_in``, zero for the
       first) and, in reverse, the gradient of the state after each chunk
       (``dh_out``: ``dfinal`` for the last, zero without it, then
       ``dh_out_{c-1} = exp(T_c) dh_out_c + Σ_i exp(cum_i) dy_i ⊗ C_i``);
    3. gradient pass, per chunk and head:
       ``du_j = Σ_{i>=j} (C_i·B_j) L_ij dy_i + exp(T - cum_j) dh_out B_j``,
       ``dx = dt du``, the direct ``ddt = x·du``;
       ``dC_i = Σ_{j<=i} L_ij (dy_i·u_j) B_j + exp(cum_i) h_inᵀ dy_i``;
       ``dB_j = Σ_{i>=j} L_ij (dy_i·u_j) C_i + exp(T - cum_j) dh_outᵀ u_j``;
       ``dcum`` from every exponent (``M_ij = (dy_i·u_j)(C_i·B_j) L_ij``
       to i and from j; ``exp(cum_i) dy_i·h_in C_i`` to i;
       ``s_j = exp(T - cum_j) u_j·dh_out B_j`` from j and to T;
       ``exp(T) Σ dh_out ∘ h_in`` to T; T's total to the chunk's last
       position); ``da`` its reverse prefix sum, ``ddt += A·da``, and the
       head's share of ``dA = Σ dt·da``;
    4. reduction: dB and dC summed over the heads, dA over rows, chunks and
       positions.

    The switches drop one part each, to show that a band can tell its
    loss: ``carry_gradient=False`` skips the reverse state pass (every
    ``dh_out`` zero, ``dfinal`` too), ``carry_state=False`` the forward
    state (every ``h_in`` zero), ``decay_gradient=False`` the ``dcum``
    chain (no ``A·da`` in ddt, dA zero), ``causal=False`` the mask of L.
    With ``split_operands`` the operands the tensor-core route computes in
    f32 become hi + lo bf16 pairs (``_split_bf16``) where it feeds them to
    its bf16 products: the weighted rows ``B ∘ dt·exp(T - cum)`` and
    ``C ∘ exp(cum)`` of pass 1, ``h_in`` and ``dh_out`` where pass 3 takes
    their products (Σ dh_out ∘ h_in stays f32), and ``W`` and ``V``; x, dy,
    B and C are taken as they come, and ``M`` stays f32.
    Positions past ``s`` are the forward's zero padding; their gradients
    are dropped. dB and dC come back in the shape B and C were given."""
    grouped = B.dim() == 4
    if grouped:
        B, C = B[:, :, 0], C[:, :, 0]
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    Af = A.to(F32)
    xq = F.pad(x.to(F32), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dyq = F.pad(dy.to(F32), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
    dtq = F.pad(dt.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    Bq = F.pad(B.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    Cq = F.pad(C.to(F32), (0, 0, 0, pad)).reshape(b, nc, chunk, n)

    op = _split_bf16 if split_operands else (lambda t: t)

    # pass 1: cum, the chunk states and the chunks' shares of dh
    cum = torch.cumsum(dtq * Af, dim=2)                                # [b,c,q,h]
    total = cum[:, :, -1]                                              # [b,c,h]
    u = xq * dtq[..., None]                                            # [b,c,q,h,p]
    to_end = torch.exp(total[:, :, None] - cum)                                     # [b,c,q,h]
    Bw = op(Bq[:, :, :, None, :] * (dtq * to_end)[..., None])                       # [b,c,q,h,n]
    Cw = op(Cq[:, :, :, None, :] * torch.exp(cum)[..., None])
    states = torch.einsum("bcqhp,bcqhn->bchpn", xq, Bw)
    dstates = torch.einsum("bcqhp,bcqhn->bchpn", dyq, Cw)

    # pass 2: h_in forward, dh_out in reverse
    zero = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    h_in, carry = [], zero
    for ci in range(nc):
        h_in.append(carry if carry_state else zero)
        carry = carry * torch.exp(total[:, ci])[..., None, None] + states[:, ci]
    dh_out = [zero] * nc
    if carry_gradient:
        dcarry = zero if dfinal is None else dfinal.to(F32)
        for ci in range(nc - 1, -1, -1):
            dh_out[ci] = dcarry
            dcarry = dcarry * torch.exp(total[:, ci])[..., None, None] + dstates[:, ci]
    h_in, dh_out = torch.stack(h_in, dim=1), torch.stack(dh_out, dim=1)   # [b,c,h,p,n]

    # pass 3: per chunk and head
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :]) if causal else torch.ones(
        (chunk, chunk), dtype=torch.bool, device=x.device)
    mask = mask[None, None, :, :, None]
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can overflow
    L = torch.exp(torch.where(mask, cum[:, :, :, None] - cum[:, :, None, :],
                              -torch.inf))                                  # [b,c,i,j,h]
    G = torch.einsum("bcin,bcjn->bcij", Cq, Bq)[..., None]                          # [b,c,i,j,1]
    D = torch.einsum("bcihp,bcjhp->bcijh", dyq, u)                                  # [b,c,i,j,h]
    W, V = G * L, D * L
    M = V * G
    W, V, h_op, dh_op = op(W), op(V), op(h_in), op(dh_out)
    du_off = torch.einsum("bcjn,bchpn->bcjhp", Bq, dh_op) * to_end[..., None]
    du = torch.einsum("bcijh,bcihp->bcjhp", W, dyq) + du_off
    dc_off = torch.einsum("bcihp,bchpn->bcihn", dyq, h_op) * torch.exp(cum)[..., None]
    dC = torch.einsum("bcijh,bcjn->bcihn", V, Bq) + dc_off
    dB = (torch.einsum("bcijh,bcin->bcjhn", V, Cq)
          + torch.einsum("bcjhp,bchpn->bcjhn", xq, dh_op) * (dtq * to_end)[..., None])
    s_j = (u * du_off).sum(-1)                                                      # [b,c,q,h]
    dcum = M.sum(3) - M.sum(2) + (Cq[:, :, :, None, :] * dc_off).sum(-1) - s_j
    last = s_j.sum(2) + torch.exp(total) * (dh_out * h_in).sum((-2, -1))            # [b,c,h]
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    if not decay_gradient:
        da = torch.zeros_like(da)
    ddt = (xq * du).sum(-1) + Af * da
    dA = (dtq * da).sum((0, 1, 2))

    # pass 4: over heads; the padded tail dropped
    dx = (dtq[..., None] * du).reshape(b, nc * chunk, h, p)[:, :s]
    dB = dB.sum(3).reshape(b, nc * chunk, n)[:, :s]
    dC = dC.sum(3).reshape(b, nc * chunk, n)[:, :s]
    ddt = ddt.reshape(b, nc * chunk, h)[:, :s]
    if grouped:
        dB, dC = dB[:, :, None], dC[:, :, None]
    return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype)
