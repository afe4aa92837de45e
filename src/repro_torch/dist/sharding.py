"""Logical-axis sharding rules of the port: the layer between model code and
the mesh.

The counterpart of ``repro/dist/sharding.py``, with the same resolution.
Model code names *logical* axes ("embed", "heads", "batch", ...) on every
parameter and cache leaf (:class:`repro_torch.models.params.Leaf`). A
:class:`ShardingRules` object maps those names to *mesh* axes ("data",
"model", "pod") and resolves the mapping per shape:

* a logical axis whose mesh axes are absent from the mesh is replicated
  (the same rules run on ``make_host_mesh()`` (1x1) and on the production
  layouts of :mod:`repro_torch.launch.mesh`);
* a dimension that the mesh-axis product does not divide falls back to
  replication and is recorded in :attr:`ShardingRules.fallbacks`, so every
  silently replicated tensor shows;
* one mesh axis is never used twice within one spec: the earlier dimension
  wins, the later one replicates.

torch has no ``PartitionSpec``; :class:`PartitionSpec` here is a small
immutable tuple of one entry per tensor dimension (``None``, a mesh-axis
name, or a tuple of names), equal entry for entry to the reference's.
:class:`NamedSharding` pairs it with a mesh and gives the local shard
shape, a rank's own block of a tensor (so each rank places its weights
from the same full tensor with no collective) and the DTensor
placements, one per mesh dimension.

Two rule sets cover the two regimes:

* :func:`make_train_rules`: FSDP over "data" (parameters shard their
  "embed" dimension), tensor-parallel over "model" (heads / ffn / vocab),
  batch over "pod"+"data"; optional sequence parallelism.
* :func:`make_decode_rules`: tensor-parallel weights (replicated over
  "data", so decode batches need no weight collectives), KV-head-sharded
  caches when the head count divides the model axis, batch over
  "pod"+"data".
"""
from __future__ import annotations

from dataclasses import dataclass, field

Axes = tuple[str | None, ...]

#: logical axis -> one-line meaning
LOGICAL_AXES = {
    # weight axes
    "vocab": "vocabulary rows of the embedding / output head",
    "embed": "model width (d_model) dimension of weight matrices",
    "heads": "flattened q/kv head projection columns (h * head_dim)",
    "ffn": "dense FFN hidden dimension",
    "experts": "MoE expert index",
    "expert_ffn": "per-expert FFN hidden dimension",
    "ssm_heads": "mamba2 inner / head projection columns",
    "layers": "stacked-layer leading dim of scanned blocks (never sharded)",
    "conv": "ssm depthwise-conv tap dim (never sharded)",
    # activation / cache axes
    "batch": "global batch rows",
    "seq": "sequence positions (sharded only under sequence parallelism)",
    "kv_seq": "cache slot positions",
    "head_dim": "per-head feature dim (never sharded)",
    "embed_act": "activation width",
    "heads_act": "activation attention heads",
    "kv_heads_act": "activation / cache KV heads",
    "ffn_act": "activation FFN hidden",
    "experts_act": "activation expert dim of MoE dispatch",
    "ssm_heads_act": "activation / cache SSM heads",
    "vocab_act": "activation logits vocabulary",
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh-axis
    name, or a tuple of names (sharded over their product, outermost
    first). Immutable; equal to any tuple (and to the reference's
    ``PartitionSpec``) with the same entries."""

    def __new__(cls, *entries):
        for e in entries:
            if not (e is None or isinstance(e, str)
                    or (isinstance(e, tuple) and all(isinstance(m, str) for m in e))):
                raise TypeError(f"a spec entry is None, an axis name or a tuple of names: {e!r}")
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what the reference's ``NamedSharding`` holds."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """Each device's block of a tensor of ``global_shape``."""
        sizes = dict(self.mesh.shape)
        if len(global_shape) != len(self.spec):
            raise ValueError(f"shape {tuple(global_shape)} and spec {self.spec} differ in rank")
        out = []
        for dim, entry in zip(global_shape, self.spec):
            n = _prod(sizes[m] for m in _names(entry))
            if dim % n:
                raise ValueError(f"dimension {dim} is not divisible by {n} ({entry!r})")
            out.append(dim // n)
        return tuple(out)

    def local_slices(self, global_shape, coords) -> tuple[slice, ...]:
        """The index ranges of the block that the device at mesh position
        ``coords`` (one index a mesh axis, :meth:`Mesh.coordinates`) holds
        of a tensor of ``global_shape``. A dimension sharded over a tuple
        of axes is split outermost axis first, as the reference's blocks
        and DTensor's are."""
        sizes = dict(self.mesh.shape)
        at = dict(zip(sizes, coords))
        block = self.shard_shape(global_shape)
        out = []
        for n, entry in zip(block, self.spec):
            i = 0
            for m in _names(entry):
                i = i * sizes[m] + at[m]
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def placements(self) -> tuple:
        """The DTensor placements, one per mesh dimension in the mesh's axis
        order: ``Shard(d)`` for each mesh axis that shards tensor dimension
        ``d``, ``Replicate()`` for the rest. A dimension sharded over a
        tuple of axes gives the reference's block order only when the tuple
        follows the mesh's axis order; any other order raises."""
        # imported here: only a mesh of more than one device needs DTensor,
        # and the one-device path imports none of it
        from torch.distributed.tensor import Replicate, Shard

        order = list(dict(self.mesh.shape))
        by_axis: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            pos = [order.index(m) for m in names]
            if pos != sorted(pos):
                raise ValueError(
                    f"dimension {d} is sharded over {names}, out of the mesh's axis order "
                    f"{tuple(order)}: DTensor would place its blocks on other ranks")
            by_axis.update(dict.fromkeys(names, d))
        return tuple(Shard(by_axis[m]) if m in by_axis else Replicate() for m in order)


@dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis mapping with divisibility-aware fallback.

    ``rules`` maps each logical axis to an ordered tuple of *candidate* mesh
    axes; resolution keeps the longest prefix of candidates that (a) exist
    in the mesh, (b) are not already used by an earlier dimension of the
    same spec, and (c) whose size product divides the dimension. An empty
    tuple (or a missing key) means "always replicate".
    """

    rules: dict[str, tuple[str, ...]]
    #: (logical_axis, mesh_axes, dim) triples that lost sharding to a
    #: divisibility or double-use fallback (deduplicated)
    fallbacks: list[tuple[str, str, int]] = field(default_factory=list)

    def spec(self, mesh, axes: Axes, shape: tuple[int, ...] | None = None
             ) -> PartitionSpec:
        """The spec of one tensor. Reads only ``mesh.shape`` (axis name ->
        size). ``shape=None`` skips the divisibility checks."""
        sizes = dict(mesh.shape)
        used: set[str] = set()
        out: list[None | str | tuple[str, ...]] = []
        for i, logical in enumerate(axes):
            cand = self.rules.get(logical) if logical is not None else None
            if not cand:
                out.append(None)
                continue
            picked = [m for m in cand if m in sizes and m not in used]
            dim = None if shape is None else shape[i]
            if dim is not None:
                # drop trailing candidates until the product divides the dim
                while picked and dim % _prod(sizes[m] for m in picked):
                    picked.pop()
            if _prod(sizes[m] for m in picked) <= 1:
                # nothing actually sharded: replicate, and record the loss
                # when the rule *wanted* a >1-way mesh axis for this dim
                wanted = [m for m in cand if sizes.get(m, 1) > 1]
                if wanted and dim is not None:
                    self._record(logical, "+".join(wanted), dim)
                out.append(None)
                continue
            used.update(picked)
            out.append(picked[0] if len(picked) == 1 else tuple(picked))
        return PartitionSpec(*out)

    def sharding(self, mesh, axes: Axes, shape: tuple[int, ...] | None = None
                 ) -> NamedSharding:
        """The :class:`NamedSharding` of one tensor on ``mesh`` (see
        :meth:`spec`)."""
        return NamedSharding(mesh, self.spec(mesh, axes, shape))

    def _record(self, logical: str, mesh_axes: str, dim: int) -> None:
        entry = (logical, mesh_axes, int(dim))
        if entry not in self.fallbacks:
            self.fallbacks.append(entry)


def _prod(it) -> int:
    p = 1
    for v in it:
        p *= v
    return p


# ------------------------------------------------------------------ rule sets
def make_train_rules(mesh, *, sequence_parallel: bool = False) -> ShardingRules:
    """FSDP + tensor-parallel training rules.

    Parameters shard their width ("embed") over the "data" axis (FSDP) and
    their hidden/head dims over "model" (TP); MoE experts take the "pod"
    axis when present. Activations keep batch over "pod"+"data" and the
    TP'd hidden dims over "model"; ``sequence_parallel`` also shards the
    sequence dimension of activations over "model". ``mesh`` is part of the
    rule-set contract (``make_decode_rules`` reads it), but train rules do
    not depend on it: they resolve against the mesh per tensor.
    """
    del mesh
    return ShardingRules({
        # weights
        "vocab": ("model",),
        "embed": ("data",),
        "heads": ("model",),
        "ffn": ("model",),
        "experts": ("pod",),
        "expert_ffn": ("model",),
        "ssm_heads": ("model",),
        # activations / caches
        "batch": ("pod", "data"),
        "seq": ("model",) if sequence_parallel else (),
        "heads_act": ("model",),
        "kv_heads_act": ("model",),
        "ffn_act": ("model",),
        "experts_act": ("model",),
        "ssm_heads_act": ("model",),
        "vocab_act": ("model",),
    })


def make_decode_rules(mesh, num_kv_heads: int) -> ShardingRules:
    """KV-head tensor-parallel decode/prefill rules.

    Weights are replicated over "data" and sharded over "model"; the KV
    cache shards its head dimension over "model" only when
    ``num_kv_heads`` divides the model axis, else the cache replicates
    (recorded as a fallback up front): a partial-head cache shard would
    split a head's softmax across devices.
    """
    tp = dict(mesh.shape).get("model", 1)
    kv_ok = tp <= 1 or num_kv_heads % tp == 0
    rules = ShardingRules({
        # weights
        "vocab": ("model",),
        "heads": ("model",),
        "ffn": ("model",),
        "expert_ffn": ("model",),
        "ssm_heads": ("model",),
        # activations / caches
        "batch": ("pod", "data"),
        "heads_act": ("model",),
        "kv_heads_act": ("model",) if kv_ok else (),
        "ffn_act": ("model",),
        "experts_act": ("model",),
        "ssm_heads_act": ("model",),
        "vocab_act": ("model",),
    })
    if not kv_ok:
        rules._record("kv_heads_act", "model", num_kv_heads)
    return rules
