"""Kernels on local shards: what a kernel entry point does with DTensors,
and the collectives a step on a mesh runs, forward and backward.

On a mesh of more than one device the model's activations are DTensors
(:class:`repro_torch.models.layers.ShardCtx` places them by the rules).
A hand-written kernel takes plain tensors, so each attention entry point
runs its own body on local shards (:func:`on_local_heads`): every rank
calls the kernel (or, on the CPU, its plain version) on the heads it
holds, and the output is again a DTensor placed as the queries are.
Operands that are already the rank's own plain tensors (the page pool's
layer slices, block tables, lengths) pass through as they are. A batch
sharded over "data" (training) stays sharded: each rank attends its own
rows.

Which KV heads a rank's query heads read: query head ``h`` reads KV head
``h // G`` (``G = H / KH``). When the rules shard the KV heads as they
shard the query heads, rank ``r`` holds query heads ``[r H/tp, (r+1)
H/tp)`` and exactly the KV heads ``[r KH/tp, (r+1) KH/tp)`` that they
read, in order. When the model axis does not divide the KV heads, the
rules replicate the KV while the query heads stay sharded: rank ``r``'s
first query head then reads KV head ``r H/tp // G``, not head 0, and its
heads may start inside a group. :func:`kv_selection` gives each rank the
KV heads its query heads read, one a query head (a group of one), so GQA
never pairs a query head with another head's keys. Under autograd each
rank's gradient of that replicated KV then covers only its own query
heads: it is a partial sum over the model axis.

Every collective goes through ``torch.distributed`` on each mesh
dimension's group (:func:`_move`), and every crossing between a DTensor
and its local block that autograd records is one of this module's
``autograd.Function``\\ s, whose backward moves the gradient with the
same collectives: :func:`redistribute` (shard -> whole is an all-gather,
whose backward reduce-scatters the summed gradient; partial -> whole is an
all-reduce, whose backward passes the gradient as it is; whole -> shard
is a slice, whose backward all-gathers), :func:`place_block` (a local
block as a DTensor; its backward brings the gradient to the block's
placements), :func:`vocab_cross_entropy`, the MoE layer's two
(:func:`summed_gradient`: a tensor whose gradient each rank takes as a
partial sum; :func:`row_mean`: the aux loss's mean over the rows' ranks,
its backward local) and the Mamba-2 block's two
(:func:`gather_columns`: chosen columns of a tensor split by columns
over the ranks, whose backward sums each column's gradient over them
once; :func:`mean_over_ranks`: the gated norm's mean over every rank's
columns, whose backward all-reduces). A partial sum is reduced in f32
whatever its type, so bf16 partial gradients round once. DTensor's
own redistribution (``DTensor.redistribute``, the implicit one an op's
sharding rule may ask for, and the one ``DTensor.from_local``'s backward
runs when a gradient comes back placed otherwise) goes through the
functional collectives instead, and under ``gloo`` on CUDA tensors those
crash the process (torch 2.11; ``torch.distributed.all_gather_into_tensor``,
``all_reduce`` and ``reduce_scatter_tensor`` work there in every dtype).
The step therefore places every activation explicitly before an op would
need it moved, gives every local block's gradient its placements
(``to_local(grad_placements=...)``), and :func:`no_functional_collectives`
turns any path that would still reach them into an error.

The int8 page format takes one scale a page over all its heads. Where a
rank's pool holds its block of a page's heads, :func:`max_reducer` gives
the all-reduce of each rank's amax over the mesh dimension that shards
them, so every rank derives the whole page's scale.

Nothing here is imported on the one-device path: :func:`is_dtensor`
reads ``sys.modules`` and imports no DTensor.
"""
from __future__ import annotations

import contextlib
import functools
import sys

import torch


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor. No DTensor exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def grad_placements(placements) -> tuple:
    """The placements of a gradient of a tensor placed by ``placements``:
    a partial sum's gradient is the whole gradient on every rank."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


def _sharded_dims(placements) -> list[int]:
    """The mesh dimensions whose placement shards a tensor dimension."""
    return [i for i, p in enumerate(placements) if p.is_shard()]


def _row_dims_of(placements) -> list[int]:
    """The mesh dimensions whose placement shards the rows (dimension 0)."""
    return [i for i, p in enumerate(placements) if p.is_shard(0)]


# ------------------------------------------------------------ collectives
def _sum_type(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type its sum over ranks is taken in: f32 for a
    lower-precision float (summing bf16 partial sums in bf16 would round
    each of them twice), else a copy of ``t``."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.clone()


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    w = _sum_type(t)
    dist.all_reduce(w, group=group)
    return w.to(t.dtype)


def _reduce_to_block(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``group``
    (a reduce-scatter), summed in f32 for a lower-precision float."""
    import torch.distributed as dist

    src = _sum_type(t).movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).to(t.dtype).contiguous()


def _move(t: torch.Tensor, mesh, cur, want) -> torch.Tensor:
    """This rank's block of a tensor placed by ``cur``, as its block under
    ``want`` (one placement a mesh dimension): on each mesh dimension whose
    placement changes, partial sums are reduced (reduce-scattered when
    ``want`` shards), shards all-gathered, and the whole split to the wanted
    shard, each on that dimension's group. Nothing is made partial."""
    import torch.distributed as dist

    for i, (c, w) in enumerate(zip(cur, want)):
        if c == w:
            continue
        if w.is_partial():
            raise ValueError(f"a tensor is not made partial: {tuple(cur)} -> {tuple(want)}")
        group, n = mesh.get_group(i), mesh.size(i)
        if c.is_partial():
            if c.reduce_op != "sum":
                raise ValueError(f"only partial sums are reduced, got {c}")
            if w.is_shard():
                t = _reduce_to_block(t, w.dim, group, n)
                continue
            t = _all_reduce_sum(t, group)
        elif c.is_shard():
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=c.dim)
        if w.is_shard():
            t = t.chunk(n, dim=w.dim)[mesh.get_local_rank(i)].contiguous()
    return t


def _local_grad(g, mesh, placements) -> torch.Tensor:
    """The local block of the gradient ``g`` (a DTensor, placed however
    autograd's ops left it) under the gradient placements of a tensor
    placed by ``placements``."""
    if not is_dtensor(g):
        raise TypeError(f"a gradient of a DTensor came back as {type(g).__name__}")
    return _move(g.to_local(), mesh, g.placements, grad_placements(placements))


class _Redistribute(torch.autograd.Function):
    """:func:`redistribute` under autograd: the backward moves the gradient
    from its placements to the input's (partial sums reduced)."""

    @staticmethod
    def forward(ctx, x, want):
        mesh = x.device_mesh
        ctx.mesh, ctx.placements, ctx.meta = mesh, tuple(x.placements), (x.shape, x.stride())
        t = _move(x.to_local(), mesh, x.placements, want)
        return _from_local(t, mesh, want, x.shape, x.stride())

    @staticmethod
    def backward(ctx, g):
        shape, stride = ctx.meta
        want = grad_placements(ctx.placements)
        t = _local_grad(g, ctx.mesh, ctx.placements)
        return _from_local(t, ctx.mesh, want, shape, stride), None


class _FromLocal(torch.autograd.Function):
    """:func:`place_block` under autograd: the backward brings the
    gradient to the block's own placements with :func:`_move` before it
    takes the local block, where ``DTensor.from_local``'s backward would
    ask DTensor to move it."""

    @staticmethod
    def forward(ctx, t, mesh, placements, shape, stride):
        ctx.mesh, ctx.placements = mesh, tuple(placements)
        return _from_local(t, mesh, placements, shape, stride)

    @staticmethod
    def backward(ctx, g):
        return _local_grad(g, ctx.mesh, ctx.placements), None, None, None, None


def _from_local(t, mesh, placements, shape, stride):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def place_block(t, mesh, placements, shape, stride=None):
    """``t``, this rank's block, as a DTensor of ``shape`` on ``mesh``
    placed by ``placements`` (no collective). Under autograd the gradient
    of ``t`` is the local block of the DTensor's gradient brought to these
    placements (a partial sum's: the whole gradient)."""
    return _FromLocal.apply(t, mesh, tuple(placements), tuple(shape),
                            tuple(stride or contiguous_strides(shape)))


def redistribute(x, want):
    """The DTensor ``x`` placed by ``want`` (one placement a mesh
    dimension). Each mesh dimension whose placement changes is made whole
    first (partial sums all-reduced in f32, shards all-gathered, on that
    dimension's group), then split to the wanted shard (a partial sum
    wanted sharded is reduce-scattered); only sums are reduced. Under
    autograd the backward is the transposed collective on the gradient:
    an all-gather's is a reduce-scatter (an all-reduce and the rank's
    block where the gradient is whole), an all-reduce's passes the
    gradient, a slice's is an all-gather. With autograd recording, ``x``
    goes through this even where ``want`` is its own placement: the
    gradient is then brought to it (a partial sum over "data" reduced)."""
    want = tuple(want)
    if want == tuple(x.placements) and not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Redistribute.apply(x, want)


# --------------------------------------------------------- local shards
def _head_shard(t, head_dim: int) -> tuple[int, int]:
    """``(position, count)`` of this rank along the mesh dimension that
    shards ``t``'s head dimension; ``(0, 1)`` when the heads are whole.
    Besides its heads, an operand may be sharded by its batch rows
    (dimension 0)."""
    from torch.distributed.tensor import Shard

    where = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == head_dim]
    if any(p.is_partial() or (p.is_shard() and p.dim not in (head_dim, 0))
           for p in t.placements):
        raise ValueError(f"attention takes its operands whole but for their heads and "
                         f"rows, got placements {t.placements}")
    if not where:
        return 0, 1
    if len(where) > 1:
        raise ValueError(f"heads sharded over more than one mesh dimension: {t.placements}")
    mesh = t.device_mesh
    return mesh.get_local_rank(where[0]), mesh.size(where[0])


def kv_selection(q, k, head_dim: int) -> torch.Tensor | None:
    """The KV heads (indices into the rank's local KV heads) that the
    rank's query heads read, one a query head, or ``None`` when the local
    KV heads are exactly those the local query heads read in order (KV
    sharded as the queries are, or both whole). ``q`` and ``k`` are
    DTensors whose ``head_dim`` holds the heads, sharded alike by rows."""
    H, KH = q.shape[head_dim], k.shape[head_dim]
    r, tp = _head_shard(q, head_dim)
    kr, ktp = _head_shard(k, head_dim)
    if _row_dims_of(q.placements) != _row_dims_of(k.placements):
        raise ValueError(f"queries placed {q.placements}, KV {k.placements}: rows differ")
    if ktp == tp:
        if kr != r:
            raise ValueError(f"query heads on shard {r} of {tp}, KV heads on {kr}")
        return None
    if ktp != 1:
        raise ValueError(f"query heads in {tp} shards, KV heads in {ktp}")
    n = H // tp
    heads = torch.arange(r * n, (r + 1) * n, device=q.device)
    return heads // (H // KH)


def on_local_heads(body, q, kv: tuple, pages: tuple = (), *, head_dim: int,
                   page_head_dim: int = 2):
    """``body(q, *kv, *pages)`` on this rank's local shards, the output
    placed as ``q`` is. ``kv`` are DTensors laid out as ``q`` (heads at
    ``head_dim``); ``pages`` are the rank's own plain tensors holding its
    KV heads at ``page_head_dim`` (the pool's layer slices). Where the
    rank's query heads read other KV heads than it holds in order
    (:func:`kv_selection`), every KV operand is narrowed to those heads,
    one a query head: on the pages that is a copy of the layer slice a
    call, the price of a layout the rules record as a fallback. Under
    autograd the KV's gradient is then a partial sum over the mesh
    dimension that shards the queries' heads."""
    from torch.distributed.tensor import Partial

    sel = kv_selection(q, kv[0], head_dim)
    kv_grad = tuple(kv[0].placements)
    if sel is not None:
        kv_grad = tuple(Partial() if qp.is_shard(head_dim) and not kp.is_shard() else kp
                        for qp, kp in zip(q.placements, kv_grad))
    q_l = q.to_local(grad_placements=tuple(q.placements))
    kv_l = tuple(t.to_local(grad_placements=kv_grad) for t in kv)
    kp = pages
    if sel is not None:
        kv_l = tuple(t.index_select(head_dim, sel) for t in kv_l)
        kp = tuple(t.index_select(page_head_dim, sel) for t in pages)
    out = body(q_l, *kv_l, *kp)
    return place_block(out, q.device_mesh, q.placements, q.shape)


def on_blocks(fn):
    """``fn(x, *args)``, a function whose result is laid out as ``x`` and
    computed along ``x``'s last dimension alone (a norm over it, RoPE over
    its pairs), run on each rank's block of ``x`` when ``x`` is a DTensor
    whose last dimension is whole and which holds no partial sums, and
    whose other DTensor arguments are replicated: one dispatch where
    DTensor would dispatch each of ``fn``'s ops. Under autograd a
    replicated argument's gradient is a partial sum over the mesh
    dimensions that shard ``x`` (each rank's rows give their share).
    Anything else runs ``fn`` as it is."""
    @functools.wraps(fn)
    def call(x, *args, **kwargs):
        if not is_dtensor(x) or not _blockwise(x, args):
            return fn(x, *args, **kwargs)
        from torch.distributed.tensor import Partial, Replicate

        split = _sharded_dims(x.placements)
        arg_grad = tuple(Partial() if i in split else Replicate()
                         for i in range(x.device_mesh.ndim))
        local = [a.to_local(grad_placements=arg_grad) if is_dtensor(a) else a for a in args]
        out = fn(x.to_local(grad_placements=tuple(x.placements)), *local, **kwargs)
        return place_block(out, x.device_mesh, x.placements, x.shape)

    return call


def _blockwise(x, args) -> bool:
    last = x.ndim - 1
    if any(p.is_partial() or p.is_shard(last) for p in x.placements):
        return False
    return all(all(p.is_replicate() for p in a.placements)
               for a in args if is_dtensor(a))


def max_reducer(mesh, placements, dim: int):
    """A function that takes this rank's ``t`` to its elementwise max over
    the ranks of every mesh dimension whose placement shards tensor
    dimension ``dim`` (an all-reduce on that dimension's group, in
    place), or ``None`` when no placement shards it: the blocks are then
    whole and a rank's own max is already everyone's. ``mesh`` is a
    DeviceMesh, ``placements`` one a mesh dimension (a page pool's)."""
    import torch.distributed as dist

    groups = [mesh.get_group(i) for i, p in enumerate(placements) if p.is_shard(dim)]
    if not groups:
        return None

    def reduce(t: torch.Tensor) -> torch.Tensor:
        for group in groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    return reduce


def full(x) -> torch.Tensor:
    """The whole of the DTensor ``x``, the same plain tensor on every
    rank."""
    from torch.distributed.tensor import Replicate

    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


class _SumGradient(torch.autograd.Function):
    """The identity, whose backward all-reduces the gradient over
    ``groups`` in f32 and rounds it once to its type (Megatron's "copy to
    the tensor-parallel region")."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        w = _sum_type(g)
        for group in ctx.groups:
            dist.all_reduce(w, group=group)
        return w.to(g.dtype), None


def summed_gradient(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t``, a plain tensor every rank of the mesh dimensions ``dims``
    holds alike, through which each of those ranks takes only its partial
    sum of the gradient (its columns of a product sharded over them): the
    backward sums the partials over their groups in f32, so each rank's
    gradient of ``t`` is the whole one. Without recording autograd, or
    with no such dimension, ``t`` as it is."""
    if not dims or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _SumGradient.apply(t, [mesh.get_group(i) for i in dims])


class _GatherColumns(torch.autograd.Function):
    """The columns ``idx`` of the whole of ``t``, a rank's block of a
    tensor split along its last dimension over ``group``: an all-gather,
    then a selection. The backward scatters the gradient into the whole
    width in f32, reduce-scatters it (each rank's block the sum over the
    group of every rank's gradient there) and rounds it once to ``t``'s
    type."""

    @staticmethod
    def forward(ctx, t, group, n, idx):
        import torch.distributed as dist

        parts = t.new_empty(n * t.numel())
        dist.all_gather_into_tensor(parts, t.contiguous().view(-1), group=group)
        whole = parts.view(n, *t.shape).movedim(0, -2).reshape(*t.shape[:-1], n * t.shape[-1])
        ctx.save_for_backward(idx)
        ctx.meta = (group, n, whole.shape, t.dtype)
        return whole.index_select(-1, idx)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        (idx,) = ctx.saved_tensors
        group, n, shape, dtype = ctx.meta
        acc = g.new_zeros(shape, dtype=torch.float32).index_add_(-1, idx, g.float())
        src = acc.reshape(*shape[:-1], n, shape[-1] // n).movedim(-2, 0).contiguous()
        out = src.new_empty(src.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), src.view(-1), group=group)
        return out.to(dtype), None, None, None


def gather_columns(t: torch.Tensor, mesh, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """The columns ``idx`` (indices into the whole last dimension) of the
    tensor of which ``t`` is this rank's block along mesh dimension
    ``dim`` (contiguous blocks of the last dimension, in rank order), a
    plain tensor. Under autograd ``t``'s gradient is its block of the sum
    over that dimension's ranks of every rank's gradient (in f32, rounded
    once): a column two ranks both select gets both shares, once."""
    return _GatherColumns.apply(t, mesh.get_group(dim), mesh.size(dim), idx)


class _MeanOverRanks(torch.autograd.Function):
    """The mean over ``group`` of each rank's ``t`` (an f32 all-reduce
    over ``n``), which every rank takes. Each rank's result feeds its own
    share of the output, so the backward all-reduces the gradient too."""

    @staticmethod
    def forward(ctx, t, group, n):
        import torch.distributed as dist

        ctx.group, ctx.n = group, n
        out = _sum_type(t)
        dist.all_reduce(out, group=group)
        return (out / n).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        w = _sum_type(g)
        dist.all_reduce(w, group=ctx.group)
        return (w / ctx.n).to(g.dtype), None, None


def mean_over_ranks(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The mean of ``t`` over the ranks of mesh dimension ``dim``, summed
    in f32, a plain tensor equal on each of them: with every rank's ``t``
    the mean over an equal share of a dimension, the mean over all of it
    (the Mamba-2 block's gated norm over its heads' columns). Under
    autograd each rank's ``t`` takes the mean of every rank's gradient."""
    return _MeanOverRanks.apply(t, mesh.get_group(dim), mesh.size(dim))


class _RowMean(torch.autograd.Function):
    """The mean of 0-d shares over ``groups``: each share divided by ``n``
    and all-reduced. The backward is local, the gradient over ``n`` on
    the rank's own share: every rank backpropagates the same loss, so an
    all-reduce there would count each share ``n`` times."""

    @staticmethod
    def forward(ctx, t, groups, n):
        import torch.distributed as dist

        ctx.n = n
        out = t / n
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def row_mean(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The mean over the ranks of the mesh dimensions ``dims`` (those that
    shard the batch's rows) of ``t``, a 0-d tensor each computes as the
    mean over its own rows: with every rank holding as many rows, the mean
    over all of them, a plain tensor equal on every rank. Under autograd
    each rank's ``t`` takes its own share of the gradient (no
    collective)."""
    if not dims:
        return t
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return _RowMean.apply(t, [mesh.get_group(i) for i in dims], n)


class _LookupRows(torch.autograd.Function):
    """``table[idx]`` whose gradient sums each row's duplicates in f32 and
    rounds once to the table's type. Autograd's own (``index_put_`` with
    ``accumulate``, and ``F.embedding``'s backward at up to 3072 indices on
    the card) adds duplicates into the bf16 gradient one by one: a token
    that fills a quarter of a 4096-token microbatch sums 1000 rows there,
    which stalls once the sum outgrows each row by 2**8 (full-width qwen's
    embedding gradient came out 0.13 off the exact one, relative
    Frobenius, on an H100)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (table.shape, table.dtype)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype = ctx.meta
        acc = torch.zeros(shape, dtype=torch.float32, device=g.device)
        acc.index_put_((idx.reshape(-1),), g.reshape(-1, *shape[1:]).float(), accumulate=True)
        return acc.to(dtype), None


def lookup_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of a plain tensor), its gradient summed in f32
    over duplicate indices (:class:`_LookupRows`): the embedding lookup of
    the training loss, on one device and on each rank's block."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _LookupRows.apply(table, idx)
    return table[idx]


def vocab_embedding(tokens, table):
    """``table[tokens]`` for a table that is a DTensor,
    replicated or sharded by rows (the vocabulary). Each rank looks up the
    tokens its rows hold and zeroes the rest: the result is a partial sum
    (the reference's masked lookup), which the caller's placement
    reduces. The table is never gathered. ``tokens`` is a plain tensor
    every rank holds whole, or a DTensor sharded by rows (a batch over
    "data"), whose rows the output keeps. Under autograd each rank's table
    gradient is its own rows' (a partial sum over the mesh dimensions that
    shard the tokens' rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tok, tok_pl = ((tokens.to_local(), tuple(tokens.placements)) if is_dtensor(tokens)
                   else (tokens, (Replicate(),) * mesh.ndim))
    if any(not (p.is_replicate() or p.is_shard(0)) for p in tok_pl):
        raise ValueError(f"tokens are whole or sharded by rows, got {tok_pl}")
    rows = _row_dims_of(tok_pl)
    where = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if len(where) > 1 or any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        raise ValueError(f"an embedding table sharded by rows alone, got {table.placements}")
    if set(where) & set(rows):
        raise ValueError(f"table rows and token rows on one mesh dimension: "
                         f"{table.placements}, {tok_pl}")
    local = table.to_local(grad_placements=tuple(
        Partial() if i in rows else p for i, p in enumerate(table.placements)))
    shape = (*tokens.shape, table.shape[1])
    placements = [Shard(0) if j in rows else Replicate() for j in range(mesh.ndim)]
    if not where:
        return place_block(lookup_rows(local, tok), mesh, placements, shape)
    (i,) = where
    n = local.shape[0]
    idx = tok - mesh.get_local_rank(i) * n
    outside = (idx < 0) | (idx >= n)
    out = lookup_rows(local, idx.clamp(0, n - 1)).masked_fill(outside[..., None], 0)
    placements[i] = Partial()
    return place_block(out, mesh, placements, shape)


# ------------------------------------------------------------------ loss
class _VocabCrossEntropy(torch.autograd.Function):
    """The mean over rows and positions of ``logsumexp(logits) -
    logits[label]`` on each rank's block of the logits ``[b, S, V/tp]``
    (f32): the log-sum-exp takes a max all-reduce and then a sum
    all-reduce over the vocabulary's groups, the gold logit a masked pick
    and a sum all-reduce, the sum over the rows an all-reduce over the
    rows' groups. The backward is local: the softmax minus the one-hot of
    the rank's vocabulary rows, over the count."""

    @staticmethod
    def forward(ctx, logits, labels, start, vocab_groups, row_groups, count):
        import torch.distributed as dist

        m = logits.amax(-1)
        for g in vocab_groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        z = torch.exp(logits - m[..., None]).sum(-1)
        for g in vocab_groups:
            dist.all_reduce(z, group=g)
        lse = m + torch.log(z)
        n = logits.shape[-1]
        idx = labels - start
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0].masked_fill(~inside, 0)
        for g in vocab_groups:
            dist.all_reduce(gold, group=g)
        total = (lse - gold).sum()
        for g in row_groups:
            dist.all_reduce(total, group=g)
        ctx.save_for_backward(logits, lse, idx, inside)
        ctx.count = count
        return total / count

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, inside = ctx.saved_tensors
        p = torch.exp(logits - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -inside[..., None].to(p.dtype))
        return p * (g / ctx.count), None, None, None, None, None


def vocab_cross_entropy(logits, labels) -> torch.Tensor:
    """``(logsumexp(logits) - logits[labels]).mean()`` for f32 logits
    ``[B, S, V]`` that are a DTensor sharded by vocabulary (their last
    dimension) and, where the batch is, by rows; ``labels`` ``[B, S]`` the
    same rows (a DTensor placed as the logits' rows, or a plain tensor
    when no rows are sharded). Returns the mean over every row of the
    batch, a plain 0-d tensor equal on every rank. Under autograd each
    rank's block of the logits gets its own gradient (no collective)."""
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    last = logits.ndim - 1
    vocab = [i for i, p in enumerate(pl) if p.is_shard(last)]
    rows = _row_dims_of(pl)
    if any(not (p.is_replicate() or p.is_shard(last) or p.is_shard(0)) for p in pl):
        raise ValueError(f"logits sharded by vocabulary and rows alone, got {pl}")
    lab = labels.to_local() if is_dtensor(labels) else labels
    if is_dtensor(labels) and _row_dims_of(labels.placements) != rows:
        raise ValueError(f"labels placed {labels.placements}, logits {pl}: rows differ")
    local = logits.to_local(grad_placements=pl)
    if lab.shape != local.shape[:-1]:
        raise ValueError(f"labels {tuple(lab.shape)} against logits {tuple(local.shape)}")
    start = 0
    for i in vocab:
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= local.shape[-1]
    return _VocabCrossEntropy.apply(
        local, lab.long(), start, [mesh.get_group(i) for i in vocab],
        [mesh.get_group(i) for i in rows], labels.numel())


#: the functional collectives DTensor's own redistribution calls
_FUNCTIONAL = ("all_reduce", "all_gather_tensor", "all_gather_single",
               "reduce_scatter_tensor", "reduce_scatter_single", "all_to_all_single",
               "broadcast", "all_gather_tensor_autograd", "reduce_scatter_tensor_autograd",
               "all_to_all_single_autograd")


@contextlib.contextmanager
def no_functional_collectives():
    """Inside the block any call of a functional collective (what
    DTensor's own redistribution runs) raises, where under ``gloo`` on
    CUDA tensors it would crash the process. A backward run inside the
    block (``torch.autograd.grad``) is inside it too, on any thread
    autograd runs it on: the functions are replaced in their module."""
    import torch.distributed._functional_collectives as funcol

    saved = {n: getattr(funcol, n) for n in _FUNCTIONAL if hasattr(funcol, n)}

    def refuse(name):
        def call(*args, **kwargs):
            raise RuntimeError(
                f"DTensor's own redistribution reached funcol.{name}: the port places "
                "every activation through repro_torch.dist.local.redistribute")
        return call

    for n in saved:
        setattr(funcol, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(funcol, n, f)
