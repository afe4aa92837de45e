"""The port's distribution layer (``repro_torch.dist``, ``launch/mesh.py``,
the placing half of ``models/params.py``) against the reference's, and the
paths that consume it.

* Every case of ``tests/test_dist_sharding.py``, on both packages side by
  side: the spec each resolves, entry for entry, and the fallbacks.
* ``spec_tree`` over every architecture at full width: ``describe()`` and
  ``describe_cache(B, S)`` at each of ``SHAPES``, under train and decode
  rules, on the reference's two production layouts (specs and fallbacks
  equal), and the fallbacks pinned on those layouts and on the port's H100
  layouts. Under a fake process group of 512 ranks each leaf placed by
  ``device_put_tree`` as a DTensor (on ``meta`` tensors) has the local
  shape the reference's ``NamedSharding.shard_shape`` gives.
* Meshes and replica sets: the host mesh, the production mesh's device
  count, disjoint and aliased replica groups, mismatched meshes refused,
  the default rules.
* The consumers on the CPU: ``Engine(placement=...)`` (the same tokens as
  without, and as the reference with its placement), the serving
  launcher's replicas (one weight copy), ``Trainer`` on a host mesh (the
  losses of ``device="cpu"`` bit for bit), ``Simulation`` with a
  ``ReplicaSet`` (the reference's ``SimResult``), and each example at its
  reduced size.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

import repro.dist as jdist
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.params import spec_tree as jax_spec_tree
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro.sim import Simulation as JaxSimulation
from repro.sim import small_test_hw as jax_small_test_hw
from repro.traces import generate_corpus as jax_generate_corpus
import repro_torch.dist as tdist
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist.sharding import NamedSharding, PartitionSpec
from repro_torch.launch.mesh import (
    Mesh,
    make_host_mesh,
    make_production_mesh,
    production_layout,
)
from repro_torch.models import Model, materialize
from repro_torch.models.config import SHAPES
from repro_torch.models.params import (
    Leaf,
    device_put_tree,
    flatten_tree,
    leaves,
    sharding_tree,
    spec_tree,
)
from repro_torch.serving import Engine, EngineRequest
from repro_torch.sim import Simulation, small_test_hw
from repro_torch.traces import generate_corpus

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Duck-typed mesh: ``spec`` only reads ``mesh.shape`` (the same stand-in
    as ``tests/test_dist_sharding.py``), for both packages."""

    def __init__(self, **shape):
        self.shape = shape


#: the reference's production layouts (TPU pods) and the port's (an H100
#: fleet, 8 GPUs of a node on the model axis)
PROD = dict(data=16, model=16)
POD = dict(pod=2, data=16, model=16)
H100 = dict(data=32, model=8)
H100_POD = dict(pod=2, data=32, model=8)
REF_LAYOUTS = {"pod16x16": PROD, "pods2x16x16": POD}
H100_LAYOUTS = {"h100_32x8": H100, "h100_2x32x8": H100_POD}

PKGS = {"jax": jdist, "torch": tdist}


def both(fn):
    """``fn(pkg)`` on the reference's ``repro.dist`` and the port's
    ``repro_torch.dist``; each result as a tuple, equal between them."""
    ref, port = fn(jdist), fn(tdist)
    assert isinstance(port, PartitionSpec)
    assert tuple(ref) == tuple(port), (ref, port)
    return port


# --------------------------------------------- tests/test_dist_sharding.py
def test_host_mesh_everything_replicated():
    for pkg, mesh in ((jdist, jax_make_host_mesh()), (tdist, make_host_mesh("cpu"))):
        rules = pkg.make_train_rules(mesh)
        for axes, shape in [
            (("vocab", "embed"), (512, 256)),
            (("embed", "heads"), (256, 256)),
            (("batch", "seq", "embed_act"), (2, 32, 256)),
        ]:
            spec = rules.spec(mesh, axes, shape)
            assert all(s is None for s in spec), (axes, spec)
        assert rules.fallbacks == []


def test_train_spec_on_production_mesh():
    mesh = FakeMesh(**PROD)

    def spec(axes, shape):
        return both(lambda pkg: pkg.make_train_rules(mesh).spec(mesh, axes, shape))

    assert spec(("embed", "heads"), (1024, 1024)) == P("data", "model")
    assert spec(("heads", "embed"), (1024, 1024)) == P("model", "data")
    assert spec(("vocab", "embed"), (151_936, 1024)) == P("model", "data")
    assert spec(("batch", "seq", "vocab_act"), (256, 4096, 151_936)) == P("data", None, "model")
    assert spec(("embed_act",), (1024,)) == P(None)


def test_multi_pod_batch_takes_both_axes():
    mesh = FakeMesh(**POD)
    assert both(lambda pkg: pkg.make_train_rules(mesh).spec(
        mesh, ("batch", "seq", "embed_act"), (256, 4096, 1024))) == P(("pod", "data"), None, None)
    assert both(lambda pkg: pkg.make_train_rules(mesh).spec(
        mesh, ("experts", "embed", "expert_ffn"), (128, 7168, 4864))) == P("pod", "data", "model")


def test_spec_without_shape_skips_divisibility():
    mesh = FakeMesh(**PROD)
    for pkg in PKGS.values():
        rules = pkg.make_train_rules(mesh)
        assert tuple(rules.spec(mesh, (None, "batch", None))) == (None, "data", None)
        assert rules.fallbacks == []


@pytest.mark.parametrize("pkg", list(PKGS))
def test_mesh_axis_never_used_twice(pkg):
    mesh = FakeMesh(**PROD)
    rules = PKGS[pkg].ShardingRules({"a": ("model",), "b": ("model",)})
    assert tuple(rules.spec(mesh, ("a", "b"), (64, 64))) == ("model", None)
    assert ("b", "model", 64) in rules.fallbacks


@pytest.mark.parametrize("model_axis", [16, 8])
def test_indivisible_dim_falls_back_to_replication(model_axis):
    """arctic's 56 q heads fall back on the reference's 16-way model axis
    and shard on the H100 layout's 8-way one."""
    mesh = FakeMesh(data=256 // model_axis, model=model_axis)
    rules = {name: pkg.make_train_rules(mesh) for name, pkg in PKGS.items()}
    spec = both(lambda pkg: rules["jax" if pkg is jdist else "torch"].spec(
        mesh, ("heads_act",), (56,)))
    if model_axis == 16:
        assert spec == P(None)
        assert rules["torch"].fallbacks == rules["jax"].fallbacks == [("heads_act", "model", 56)]
    else:
        assert spec == P("model")
        assert rules["torch"].fallbacks == rules["jax"].fallbacks == []


def test_batch_of_one_replicates_and_records():
    mesh = FakeMesh(**PROD)
    for pkg in PKGS.values():
        rules = pkg.make_decode_rules(mesh, num_kv_heads=16)
        assert tuple(rules.spec(mesh, ("batch",), (1,))) == (None,)
        assert ("batch", "data", 1) in rules.fallbacks


def test_partial_axis_product_kept():
    mesh = FakeMesh(**POD)
    assert both(lambda pkg: pkg.make_train_rules(mesh).spec(mesh, ("batch",), (16,))) == P("pod")


def test_decode_weights_replicated_over_data():
    mesh = FakeMesh(**PROD)
    w = (("embed", "heads"), (1024, 2048))
    assert both(lambda pkg: pkg.make_train_rules(mesh).spec(mesh, *w)) == P("data", "model")
    assert both(lambda pkg: pkg.make_decode_rules(mesh, 16).spec(mesh, *w)) == P(None, "model")


def test_decode_kv_head_sharding_requires_divisibility():
    mesh = FakeMesh(**PROD)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads_act", "head_dim")
    assert both(lambda pkg: pkg.make_decode_rules(mesh, num_kv_heads=16).spec(
        mesh, kv_axes, (24, 128, 32_768, 16, 64))) == P(None, "data", None, "model", None)
    for pkg in PKGS.values():
        bad = pkg.make_decode_rules(mesh, num_kv_heads=12)
        assert bad.fallbacks == [("kv_heads_act", "model", 12)]
        spec = bad.spec(mesh, kv_axes, (24, 128, 32_768, 12, 64))
        assert tuple(spec) == (None, "data", None, None, None)


def test_sequence_parallel_shards_seq_over_model():
    mesh = FakeMesh(**PROD)
    act = (("batch", "seq", "embed_act"), (256, 4096, 1024))
    assert both(lambda pkg: pkg.make_train_rules(mesh, sequence_parallel=True).spec(
        mesh, *act)) == P("data", "model", None)
    assert both(lambda pkg: pkg.make_train_rules(mesh).spec(mesh, *act)) == P("data", None, None)


def test_sharding_tree_round_trip_on_host_mesh():
    """The reference's round trip on the port's host mesh: every leaf gets a
    sharding, placing the tree keeps shapes, dtypes and values (and moves
    nothing: the same tensors come back), and the glossary covers every
    logical axis the model names."""
    mesh = make_host_mesh("cpu")
    cfg = get_config("qwen1.5-0.5b").reduced()
    tree = Model(cfg).describe()
    rules = tdist.make_decode_rules(mesh, cfg.num_kv_heads)
    shardings = sharding_tree(tree, mesh, rules)
    flat = dict(flatten_tree(shardings))
    assert set(flat) == {name for name, _ in leaves(tree)}
    assert all(isinstance(s, NamedSharding) and s.mesh is mesh for s in flat.values())
    params = materialize(tree, seed=0)
    placed = device_put_tree(params, shardings)
    for (_, a), (_, b) in zip(flatten_tree(params), flatten_tree(placed)):
        assert a is b and type(b) is torch.Tensor
    named = {ax for _, l in leaves(tree) for ax in l.axes if ax is not None}
    assert named <= set(tdist.LOGICAL_AXES), named - set(tdist.LOGICAL_AXES)
    assert tdist.LOGICAL_AXES == jdist.LOGICAL_AXES


def test_replica_set_shares_one_rules_object():
    cfg = get_config("qwen1.5-0.5b").reduced()
    rs = tdist.make_replica_set(3, num_kv_heads=cfg.num_kv_heads, devices=[CPU])
    jrs = jdist.make_replica_set(3, num_kv_heads=cfg.num_kv_heads)
    assert rs.num_replicas == len(rs) == jrs.num_replicas == 3
    placements = list(rs)
    assert all(p.rules is rs.rules for p in placements)
    assert [p.replica_id for p in placements] == [0, 1, 2]
    assert dict(placements[0].mesh.shape) == dict(placements[2].mesh.shape) \
        == dict(jrs.placement(0).mesh.shape)
    assert placements[1].spec(("batch", "vocab_act")) == P(None, None)
    assert rs.rules.rules == jrs.rules.rules and rs.rules.fallbacks == jrs.rules.fallbacks


def test_replica_set_rejects_undersized_mesh():
    with pytest.raises(AssertionError):
        jdist.make_replica_set(1, mesh_shape=(2, 2), devices=jax.devices())
    with pytest.raises(ValueError, match="need 4 devices"):
        tdist.make_replica_set(1, mesh_shape=(2, 2), devices=[CPU])


def test_decode_rules_drive_a_real_prefill():
    """The quickstart path in miniature: weights placed by the host mesh's
    decode rules give the model's logits of unplaced weights, bit for bit."""
    mesh = make_host_mesh("cpu")
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    placed = device_put_tree(params, sharding_tree(
        Model(cfg).describe(), mesh, tdist.make_decode_rules(mesh, cfg.num_kv_heads)))
    B, S = 2, 16
    tokens = torch.arange(B * S).reshape(B, S) % cfg.vocab_size
    logits, _ = Model(cfg, placed).prefill({"tokens": tokens})
    want, _ = Model(cfg, params).prefill({"tokens": tokens})
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.equal(logits, want)


# --------------------------------------------------- the port's own pieces
def test_named_sharding_shard_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(**H100_POD)
    s = NamedSharding(mesh, PartitionSpec(("pod", "data"), None, "model"))
    assert s.shard_shape((256, 4096, 1024)) == (4, 4096, 128)
    assert s.placements() == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, PartitionSpec(None, "data")).placements() \
        == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="not divisible"):
        s.shard_shape((100, 4096, 1024))
    with pytest.raises(ValueError, match="out of the mesh's axis order"):
        NamedSharding(mesh, PartitionSpec(("data", "pod"))).placements()
    with pytest.raises(TypeError):
        PartitionSpec(3)
    assert repr(PartitionSpec("data", None)) == "PartitionSpec('data', None)"


def test_meshes():
    host = make_host_mesh("cpu")
    assert dict(host.shape) == {"data": 1, "model": 1} and host.device() == CPU
    for multi_pod, want in ((False, H100), (True, H100_POD)):
        layout = production_layout(multi_pod)
        assert dict(layout.shape) == want and layout.size == 256 * (1 + multi_pod)
        assert layout.devices is None
        with pytest.raises(ValueError, match="not a mesh of one device"):
            layout.device()
    cards = [torch.device("cuda", i) for i in range(256)]   # names only: no card needed
    mesh = make_production_mesh(devices=cards)
    assert dict(mesh.shape) == H100 and mesh.devices[1, 0] == torch.device("cuda", 8)
    with pytest.raises(RuntimeError, match="needs 256 devices, 8 present"):
        make_production_mesh(devices=cards[:8])
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, devices=cards)
    with pytest.raises(RuntimeError, match="process group"):
        host.device_mesh()
    with pytest.raises(ValueError, match="one device type"):
        Mesh(("data",), [CPU, torch.device("cuda", 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.make_replica_set(2)


def test_replica_groups_disjoint_or_aliased():
    cards = [torch.device("cuda", i) for i in range(8)]
    rs = tdist.make_replica_set(4, mesh_shape=(1, 2), devices=cards)
    groups = [list(p.mesh.devices.flat) for p in rs]
    assert groups == [cards[0:2], cards[2:4], cards[4:6], cards[6:8]]
    assert [p.mesh.ranks.ravel().tolist() for p in rs] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    rs = tdist.make_replica_set(4, mesh_shape=(1, 2), devices=cards[:5])
    assert all(list(p.mesh.devices.flat) == cards[:2] for p in rs)
    # one card: every replica aliases cuda:0
    rs = tdist.make_replica_set(2, devices=cards[:1])
    assert [p.mesh.device() for p in rs] == [torch.device("cuda", 0)] * 2


def test_mismatched_replica_meshes_refused():
    a = make_host_mesh("cpu")
    b = Mesh(("data", "model"), np.array([[CPU, CPU]], dtype=object))
    with pytest.raises(ValueError, match="replica meshes must match"):
        tdist.ReplicaSet([a, b], tdist.make_decode_rules(a, 1))
    with pytest.raises(AssertionError, match="replica meshes must match"):
        jdist.ReplicaSet([FakeMesh(data=1, model=1), FakeMesh(data=1, model=2)],
                         jdist.make_decode_rules(FakeMesh(data=1, model=1), 1))
    with pytest.raises(ValueError, match="at least one mesh"):
        tdist.ReplicaSet([], tdist.make_decode_rules(a, 1))


@pytest.mark.parametrize("kv_heads", [16, 12])
def test_default_rules_are_the_references(kv_heads):
    """On the host mesh, and on a 16-way model axis (the reference's layout:
    12 KV heads fall back, recorded up front)."""
    rs = tdist.make_replica_set(2, num_kv_heads=kv_heads, devices=[CPU])
    jrs = jdist.make_replica_set(2, num_kv_heads=kv_heads)
    assert rs.rules.rules == jrs.rules.rules and rs.rules.fallbacks == jrs.rules.fallbacks == []
    cards = [torch.device("cuda", i) for i in range(16)]
    rs = tdist.make_replica_set(1, mesh_shape=(1, 16), devices=cards, num_kv_heads=kv_heads)
    want = jdist.make_decode_rules(FakeMesh(data=1, model=16), kv_heads)
    assert rs.rules.rules == want.rules and rs.rules.fallbacks == want.fallbacks
    assert rs.rules.fallbacks == ([] if kv_heads == 16 else [("kv_heads_act", "model", 12)])


# ----------------------------------------------- every architecture's trees
def _flat_specs(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


def _trees(model, cfg):
    """``(name, describe tree)``: the parameters, then the cache at each of
    ``SHAPES``."""
    yield "params", model.describe()
    for shape in SHAPES.values():
        yield shape.name, model.describe_cache(shape.global_batch, shape.seq_len)


def _rules(pkg, kind, mesh, cfg):
    return (pkg.make_train_rules(mesh) if kind == "train"
            else pkg.make_decode_rules(mesh, cfg.num_kv_heads))


#: the fallbacks (logical axis, dimension) every architecture's trees
#: record, on a 16-way model axis (the reference's layouts) and an 8-way
#: one (the H100 layouts): long_500k's batch of one everywhere; 8 KV heads
#: and the vocabularies that 16 does not divide; on 8 only whisper's and
#: internvl2's vocabularies (51,865 and 92,553 are odd)
BATCH1 = {("batch", 1)}
FALLBACKS = {
    16: {
        "mamba2-2.7b": {("vocab", 50280)},
        "internlm2-20b": {("kv_heads_act", 8)},
        "gemma2-27b": set(),
        "gemma2-9b": {("kv_heads_act", 8)},
        "qwen1.5-0.5b": set(),
        "arctic-480b": {("kv_heads_act", 8)},
        "dbrx-132b": {("kv_heads_act", 8)},
        "whisper-medium": {("vocab", 51865)},
        "internvl2-26b": {("vocab", 92553), ("kv_heads_act", 8)},
        "zamba2-2.7b": set(),
    },
    8: {arch: set() for arch in ARCH_IDS} | {
        "whisper-medium": {("vocab", 51865)},
        "internvl2-26b": {("vocab", 92553)},
    },
}


def _pinned(arch: str, layout: dict) -> set:
    batch_axes = "pod+data" if "pod" in layout else "data"
    want = {(ax, "model", dim) for ax, dim in FALLBACKS[layout["model"]][arch]}
    return want | {(ax, batch_axes, dim) for ax, dim in BATCH1}


@pytest.mark.parametrize("layout", list(REF_LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_matches_reference_at_full_width(arch, layout):
    mesh = FakeMesh(**REF_LAYOUTS[layout])
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    for kind in ("train", "decode"):
        rules, jrules = _rules(tdist, kind, mesh, cfg), _rules(jdist, kind, mesh, jcfg)
        for (name, tree), (_, jtree) in zip(_trees(model, cfg), _trees(jmodel, jcfg)):
            got = _flat_specs(spec_tree(tree, mesh, rules))
            want = _flat_specs(jax_spec_tree(jtree, mesh, jrules))
            assert got == want, (kind, name)
        assert rules.fallbacks == jrules.fallbacks, kind
        assert set(rules.fallbacks) == _pinned(arch, REF_LAYOUTS[layout]), kind


@pytest.mark.parametrize("layout", list(H100_LAYOUTS))
def test_fallbacks_on_the_h100_layouts(layout):
    mesh = FakeMesh(**H100_LAYOUTS[layout])
    assert dict(production_layout("pod" in H100_LAYOUTS[layout]).shape) == H100_LAYOUTS[layout]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = Model(cfg)
        for kind in ("train", "decode"):
            rules = _rules(tdist, kind, mesh, cfg)
            for _, tree in _trees(model, cfg):
                spec_tree(tree, mesh, rules)
            assert set(rules.fallbacks) == _pinned(arch, H100_LAYOUTS[layout]), (arch, kind)


# -------------------------------------------- DTensor under a fake group
@pytest.fixture(scope="module")
def fake_group():
    """A fake process group of 512 ranks in this process; destroyed after
    the module (other files may run in the same worker)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    yield
    dist.destroy_process_group()


def _meta_tree(tree) -> dict:
    return {k: (torch.empty(v.shape, dtype=v.dtype, device="meta") if isinstance(v, Leaf)
                else _meta_tree(v)) for k, v in tree.items()}


@pytest.mark.parametrize("layout", list(REF_LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dtensor_local_shapes_match_reference(fake_group, arch, layout):
    from torch.distributed.tensor import DTensor

    sizes = REF_LAYOUTS[layout]
    mesh = Mesh(tuple(sizes), sizes=tuple(sizes.values()), device_type="cpu")
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    for kind in ("train", "decode"):
        rules, jrules = _rules(tdist, kind, mesh, cfg), _rules(jdist, kind, amesh, jcfg)
        for (name, tree), (_, jtree) in zip(_trees(model, cfg), _trees(jmodel, jcfg)):
            placed = dict(flatten_tree(device_put_tree(
                _meta_tree(tree), sharding_tree(tree, mesh, rules))))
            jspecs = _flat_specs(jax_spec_tree(jtree, amesh, jrules))
            for leaf_name, l in leaves(tree):
                t = placed[leaf_name]
                assert isinstance(t, DTensor) and tuple(t.shape) == l.shape
                want = JaxNamedSharding(amesh, P(*jspecs[leaf_name])).shard_shape(l.shape)
                assert tuple(t.to_local().shape) == want, (kind, name, leaf_name)


# ------------------------------------------------------------- consumers
ENGINE_KW = dict(page_tokens=8, n_device_pages=48, n_host_pages=32, max_slots=2,
                 max_seq=128, prefill_bucket_tokens=16, prefill_chunk_tokens=16)


def _serve(engine, req_cls, ctxs):
    for pid, ctx in ctxs.items():
        engine.submit(req_cls(pid, ctx, max_new_tokens=5))
    return {c.program_id: list(c.output_tokens) for c in engine.run_to_completion()}


def _in_tie_set(jmodel, jparams, ctx, tokens, ref_tokens):
    """Each port token equals the reference's or is in the tie set of the
    reference's bf16-rounded logits at the port's context."""
    cur = list(ctx)
    for tok, ref_tok in zip(tokens, ref_tokens):
        if tok != ref_tok:
            jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([cur], jnp.int32)})
            rounded = np.asarray(jnp.asarray(jlogits[0], jnp.bfloat16).astype(jnp.float32))
            assert rounded[tok] == rounded.max(), (tok, ref_tok)
        cur.append(tok)


def test_engine_with_a_placement_serves_as_without_and_as_the_reference():
    cfg, jcfg = get_config("qwen1.5-0.5b").reduced(), jax_get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    rng = np.random.default_rng(0)
    ctxs = {"a": rng.integers(2, cfg.vocab_size, 37).tolist(),
            "b": rng.integers(2, cfg.vocab_size, 20).tolist()}
    rs = tdist.make_replica_set(2, num_kv_heads=cfg.num_kv_heads, devices=[CPU])
    placed = [Engine(cfg, params, placement=p, **ENGINE_KW) for p in rs]
    assert all(e.device == CPU and e.placement.rules is rs.rules for e in placed)
    # aliased replicas hold one copy of the weights: the caller's tensors
    for (_, a), (_, b), (_, c) in zip(flatten_tree(params), flatten_tree(placed[0].model._stacked),
                                      flatten_tree(placed[1].model._stacked)):
        assert a is b is c
    got = _serve(placed[0], EngineRequest, ctxs)
    assert got == _serve(Engine(cfg, params, device="cpu", **ENGINE_KW), EngineRequest, ctxs)
    jrs = jdist.make_replica_set(1, num_kv_heads=jcfg.num_kv_heads)
    jgot = _serve(JaxEngine(jcfg, jparams, placement=jrs.placement(0), **ENGINE_KW),
                  JaxRequest, ctxs)
    for pid, ctx in ctxs.items():
        assert len(got[pid]) == len(jgot[pid])
        _in_tie_set(jmodel, jparams, ctx, got[pid], jgot[pid])


def test_engine_refuses_a_larger_mesh_or_another_device():
    # a model axis is served (tests/test_torch_tp.py); a data axis is not yet
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    rs = tdist.make_replica_set(1, mesh_shape=(2, 1), devices=[CPU, CPU])
    with pytest.raises(NotImplementedError, match="other than 'model'.*ROADMAP"):
        Engine(cfg, params, placement=rs.placement(0), **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="other than 'model'.*ROADMAP"):
        Engine(cfg, params, placement=rs.placement(0), device="cpu", **ENGINE_KW)
    one = tdist.make_replica_set(1, devices=[CPU]).placement(0)
    with pytest.raises(ValueError, match="not the mesh's device"):
        Engine(cfg, params, placement=one, device="cuda:0", **ENGINE_KW)
    Engine(cfg, params, placement=one, device="cpu", **ENGINE_KW)


def test_serve_launcher_places_replicas_on_one_weight_copy():
    from repro_torch.launch import serve

    args = serve.parse_args(["--device", "cpu", "--reduced", "--replicas", "3"])
    cfg, engines, router = serve.build_router(args)
    assert len(engines) == len(router.engines) == 3
    rules = engines[0].placement.rules
    assert [e.placement.replica_id for e in engines] == [0, 1, 2]
    assert all(e.placement.rules is rules and e.device == CPU for e in engines)
    assert rules.rules == jdist.make_decode_rules(FakeMesh(data=1, model=1),
                                                  cfg.num_kv_heads).rules
    ptrs = [[t.data_ptr() for _, t in flatten_tree(e.model._stacked)] for e in engines]
    assert ptrs[0] == ptrs[1] == ptrs[2]


def _losses(trainer) -> list[float]:
    state = trainer.init_state()
    trainer.run(state)
    return [m["loss"] for m in trainer.metrics]


def test_trainer_on_a_host_mesh_is_the_device_trainer():
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = get_config("qwen1.5-0.5b").reduced()

    def make(**kw):
        return Trainer(cfg, TrainConfig(steps=3, microbatches=2, log_every=1),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4), **kw)

    on_mesh = make(mesh=make_host_mesh("cpu"))
    assert on_mesh.device == CPU and dict(on_mesh.mesh.shape) == {"data": 1, "model": 1}
    assert on_mesh.rules.rules == jdist.make_train_rules(None).rules
    p_sh, o_sh = on_mesh.shardings()
    assert set(dict(flatten_tree(p_sh))) == {n for n, _ in leaves(on_mesh.param_tree)}
    assert set(dict(flatten_tree(o_sh))) == {n for n, _ in leaves(on_mesh.opt_tree)}
    losses = _losses(on_mesh)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses == _losses(make(device="cpu"))
    # a mesh of more than one device steps SPMD, one process a rank: the
    # trainer steps this rank's device, which needs a process group (the
    # module's fake group may still be up in this worker)
    import torch.distributed as dist

    two = Mesh(("data", "model"), np.array([[CPU, CPU]], dtype=object))
    if dist.is_initialized():
        on_two = make(mesh=two)
        assert on_two.device == CPU and on_two.ctx.mesh is two
    else:
        with pytest.raises(RuntimeError, match="needs a process group"):
            make(mesh=two)
    with pytest.raises(ValueError, match="not the mesh's device"):
        make(mesh=make_host_mesh("cpu"), device="cuda:0")


def test_simulation_with_a_replica_set_matches_reference():
    def run(port: bool):
        corpus_fn, hw_fn, sim_cls = ((generate_corpus, small_test_hw, Simulation) if port else
                                     (jax_generate_corpus, jax_small_test_hw, JaxSimulation))
        placement = (tdist.make_replica_set(3, devices=[CPU]) if port
                     else jdist.make_replica_set(3))
        sim = sim_cls("mori", hw_fn(hbm_bytes=200_000_000), corpus_fn(30, seed=4),
                      placement=placement, concurrency_per_replica=8, duration_s=400.0,
                      warmup_s=20.0, seed=0)
        result = sim.run().to_dict()
        for key in ("tick_avg_ms", "tick_p99_ms"):      # wall clock
            result.pop(key)
        assert sim.placement is placement and len(sim.replicas) == 3
        assert sim.placement.rules.fallbacks == []
        return result

    port = run(True)
    assert port["steps_completed"] > 0
    assert port == run(False)


EXAMPLES = {
    "quickstart": ["--programs", "3"],
    "serve_agents": ["--programs", "2"],
    "multi_replica_sim": ["--programs", "8", "--duration-s", "60", "--conc", "10"],
    "train_lm": ["--steps", "20", "--d-model", "64", "--layers", "2", "--seq-len", "32",
                 "--batch", "4"],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main([*EXAMPLES[name], "--device", "cpu"])
    out = capsys.readouterr().out
    if name in ("quickstart", "train_lm"):
        assert out.rstrip().splitlines()[-1].startswith("ok")
    if name == "quickstart":
        assert "host mesh {'data': 1, 'model': 1} on cpu" in out
        assert int(re.search(r"completed steps\s+: (\d+)", out).group(1)) > 0
    if name == "serve_agents":
        rows = [l for l in out.splitlines() if l.split()[:1] in (["mori"], ["ta+o"], ["ta"],
                                                                  ["smg"])]
        assert len(rows) == 4 and all(int(r.split()[1]) > 0 for r in rows)
    if name == "multi_replica_sim":
        assert "DP=3" in out and "finished" in out
    if name == "train_lm":
        assert "injected node failure at step 10" in out and "resumed at step 10" in out
