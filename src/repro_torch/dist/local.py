"""Kernels on local shards: what a kernel entry point does with DTensors.

On a mesh of more than one device the model's activations are DTensors
(:class:`repro_torch.models.layers.ShardCtx` places them by the rules).
A hand-written kernel takes plain tensors, so each attention entry point
runs its own body under ``torch.distributed.tensor.experimental.local_map``:
every rank calls the kernel (or, on the CPU, its plain version) on the
heads it holds, and the output is again a DTensor placed as the queries
are. Operands that are already the rank's own plain tensors (the page
pool's layer slices, block tables, lengths) pass through as they are.

Which KV heads a rank's query heads read: query head ``h`` reads KV head
``h // G`` (``G = H / KH``). When the rules shard the KV heads as they
shard the query heads, rank ``r`` holds query heads ``[r H/tp, (r+1)
H/tp)`` and exactly the KV heads ``[r KH/tp, (r+1) KH/tp)`` that they
read, in order. When the model axis does not divide the KV heads, the
rules replicate the KV (``make_decode_rules``) while the query heads stay
sharded: rank ``r``'s first query head then reads KV head ``r H/tp // G``,
not head 0, and its heads may start inside a group. :func:`kv_selection`
gives each rank the KV heads its query heads read, one a query head (a
group of one), so GQA never pairs a query head with another head's keys.

Every collective goes through :func:`redistribute`, which moves the
local blocks with ``torch.distributed``'s own collectives on each mesh
dimension's group and wraps the result with ``DTensor.from_local``.
DTensor's own redistribution (``DTensor.redistribute``, and the implicit
one an op's sharding rule may ask for) goes through the functional
collectives instead, and under ``gloo`` on CUDA tensors those crash the
process (torch 2.11; ``torch.distributed.all_gather_into_tensor`` and
``all_reduce`` work there in every dtype). The model's step therefore
places every activation explicitly before an op would need it moved, and
:func:`no_functional_collectives` turns any path that would still reach
them into an error.

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
import torch.nn.functional as F


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor. No DTensor exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _head_shard(t, head_dim: int) -> tuple[int, int]:
    """``(position, count)`` of this rank along the mesh dimension that
    shards ``t``'s head dimension; ``(0, 1)`` when the heads are whole."""
    from torch.distributed.tensor import Partial, Shard

    where = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == head_dim]
    if any(isinstance(p, Shard) and p.dim != head_dim or isinstance(p, Partial)
           for p in t.placements):
        raise ValueError(f"attention takes its operands whole but for their heads, "
                         f"got placements {t.placements}")
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
    DTensors whose ``head_dim`` holds the heads."""
    H, KH = q.shape[head_dim], k.shape[head_dim]
    r, tp = _head_shard(q, head_dim)
    kr, ktp = _head_shard(k, head_dim)
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
    """``body(q, *kv, *pages)`` on this rank's local shards under
    ``local_map``, the output placed as ``q`` is. ``kv`` are DTensors laid
    out as ``q`` (heads at ``head_dim``); ``pages`` are the rank's own
    plain tensors holding its KV heads at ``page_head_dim`` (the pool's
    layer slices). Where the rank's query heads read other KV heads than
    it holds in order (:func:`kv_selection`), every KV operand is narrowed
    to those heads, one a query head: on the pages that is a copy of the
    layer slice a call, the price of a layout the rules record as a
    fallback."""
    from torch.distributed.tensor.experimental import local_map

    sel = kv_selection(q, kv[0], head_dim)

    def run(q_l, *kv_l):
        kp = pages
        if sel is not None:
            kv_l = tuple(t.index_select(head_dim, sel) for t in kv_l)
            kp = tuple(t.index_select(page_head_dim, sel) for t in pages)
        return body(q_l, *kv_l, *kp)

    return local_map(run, out_placements=list(q.placements),
                     device_mesh=q.device_mesh)(q, *kv)


def on_blocks(fn):
    """``fn(x, *args)``, a function whose result is laid out as ``x`` and
    computed along ``x``'s last dimension alone (a norm over it, RoPE over
    its pairs), run on each rank's block of ``x`` under ``local_map`` when
    ``x`` is a DTensor whose last dimension is whole and which holds no
    partial sums, and whose other DTensor arguments are replicated: one
    dispatch where DTensor would dispatch each of ``fn``'s ops. Anything
    else runs ``fn`` as it is."""
    @functools.wraps(fn)
    def call(x, *args, **kwargs):
        if not is_dtensor(x) or not _blockwise(x, args):
            return fn(x, *args, **kwargs)
        from torch.distributed.tensor.experimental import local_map

        return local_map(fn, out_placements=list(x.placements),
                         device_mesh=x.device_mesh)(x, *args, **kwargs)

    return call


def _blockwise(x, args) -> bool:
    last = x.ndim - 1
    if any(p.is_partial() or p.is_shard(last) for p in x.placements):
        return False
    return all(all(p.is_replicate() for p in a.placements)
               for a in args if is_dtensor(a))


def contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def place_block(t, mesh, placements, shape, stride=None):
    """``t``, this rank's block, as a DTensor of ``shape`` on ``mesh``
    placed by ``placements`` (no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=stride or contiguous_strides(shape))


def redistribute(x, want):
    """The DTensor ``x`` placed by ``want`` (one placement a mesh
    dimension). Each mesh dimension whose placement changes is made whole
    first (partial sums all-reduced, shards all-gathered, on that
    dimension's group), then split to the wanted shard; only sums are
    reduced."""
    import torch.distributed as dist

    mesh, t = x.device_mesh, x.to_local()
    want = tuple(want)
    for i, (cur, new) in enumerate(zip(x.placements, want)):
        if cur == new:
            continue
        group, n = mesh.get_group(i), mesh.size(i)
        if cur.is_partial():
            if cur.reduce_op != "sum":
                raise ValueError(f"only partial sums are reduced, got {cur}")
            t = t.clone()
            dist.all_reduce(t, group=group)
        elif cur.is_shard():
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=cur.dim)
        if new.is_shard():
            t = t.chunk(n, dim=new.dim)[mesh.get_local_rank(i)].contiguous()
        elif new.is_partial():
            raise ValueError(f"a tensor is not made partial: {x.placements} -> {want}")
    return place_block(t, mesh, want, x.shape, x.stride())


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


def vocab_embedding(tokens, table):
    """``F.embedding(tokens, table)`` for a table that is a DTensor,
    replicated or sharded by rows (the vocabulary). Each rank looks up the
    tokens its rows hold and zeroes the rest: the result is a partial sum
    (the reference's masked lookup), which the caller's placement
    reduces. The table is never gathered."""
    from torch.distributed.tensor import Partial, Replicate

    local = table.to_local()
    where = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not where:
        return place_block(F.embedding(tokens, local), table.device_mesh,
                        [Replicate()] * table.device_mesh.ndim, (*tokens.shape, table.shape[1]))
    if len(where) > 1 or any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        raise ValueError(f"an embedding table sharded by rows alone, got {table.placements}")
    (i,) = where
    n = local.shape[0]
    idx = tokens - table.device_mesh.get_local_rank(i) * n
    outside = (idx < 0) | (idx >= n)
    out = F.embedding(idx.clamp(0, n - 1), local).masked_fill(outside[..., None], 0)
    placements = [Partial() if j == i else Replicate() for j in range(table.device_mesh.ndim)]
    return place_block(out, table.device_mesh, placements, (*tokens.shape, table.shape[1]))


#: the functional collectives DTensor's own redistribution calls
_FUNCTIONAL = ("all_reduce", "all_gather_tensor", "all_gather_single",
               "reduce_scatter_tensor", "reduce_scatter_single", "all_to_all_single",
               "broadcast", "all_gather_tensor_autograd", "reduce_scatter_tensor_autograd",
               "all_to_all_single_autograd")


@contextlib.contextmanager
def no_functional_collectives():
    """Inside the block any call of a functional collective (what
    DTensor's own redistribution runs) raises, where under ``gloo`` on
    CUDA tensors it would crash the process."""
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
