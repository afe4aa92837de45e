"""The port's captured chunk prefill against the JAX reference, on the CPU.

The reference jits its chunk prefill once per (prefix-page bucket x chunk
bucket) with every per-call value a traced operand (``_chunk_prefill_fn``,
``_chunk_prefill_impl(_q)``); the port captures ``Engine.chunk_packed``
once per bucket as a CUDA graph over a staged int32 vector. On the CPU a
graph cache runs its step eagerly, so these hold the step the card
captures; ``tests/test_torch_graphs_on_card.py`` holds the card's replays
against it bit for bit.

* Every chunk bucket's staged step, on a pool drawn from a seed with a
  real prefix and a ragged chunk, against the reference's jitted chunk
  step on the same pool, pages, tokens, ``pos0`` and ``take``, bf16 and
  int8 pages: logits in the model band (2**-4 + 2**-6·|x|), the greedy
  token in the reference's bf16 tie set, every page the step does not
  write bit-equal, and the written pages within the model band taken at
  each page's largest magnitude (``kv_quant``'s error model: one scale a
  page) plus, on int8 pages, one int8 step.
* A warmed engine's chunked follow-up gives the reference engine's tokens
  and replays only chunk buckets that warmup captured.
* The pieces that make the step capturable are bit-equal to the host-int
  forms they replace: ``blockwise_attention`` with the hole's lower end
  as a tensor, ``Model.prefill`` with tensor ``positions_offset``,
  ``prefix_valid`` and ``logit_index`` (a vlm prefix of image embeddings
  too), and the flash wrapper's checks of a device lower end.
* A chunk bucket first met after warmup fails the router's capture-budget
  gate.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro.serving.engine import _chunk_prefill_fn
from repro_torch.analysis import compile_tracker
from repro_torch.configs import get_config
from repro_torch.core.types import ProgramTrace, RequestRecord
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import blockwise_attention
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, EngineRequest, MoriRouter
from test_torch_engine import ENGINE_KW
from test_torch_engine import check_tokens as check_engine_tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the model band of tests/test_torch_model.py
ATOL, RTOL = 2**-4, 2**-6
#: the jitaudit geometry: prefix buckets 0, 4 and 8 pages, chunks 32 and 64
SPEC_KW = dict(page_tokens=16, n_device_pages=96, n_host_pages=8, max_slots=2, max_seq=128)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, params, jcfg, jmodel, jparams


def seeded_pool(eng: Engine, seed: int) -> dict:
    """Fill the engine's pool from a seed (values a context would hold) and
    return its tensors as numpy arrays, the reference's operands."""
    rng = np.random.default_rng(seed)
    pool = eng.pool
    out = {}
    for name in ("k", "v"):
        t = getattr(pool, name)
        if pool.quantized_device:
            vals = rng.integers(-127, 128, t.shape).astype(np.int8)
            t.copy_(torch.from_numpy(vals))
            out[name] = vals
        else:
            vals = rng.standard_normal(t.shape, dtype=np.float32)
            t.copy_(torch.from_numpy(vals).to(t.dtype))
            out[name] = t.float().numpy()
    if pool.quantized_device:
        for name in ("k_scale", "v_scale"):
            t = getattr(pool, name)
            vals = (rng.random(t.shape, dtype=np.float32) * 0.02 + 0.002).astype(np.float32)
            t.copy_(torch.from_numpy(vals))
            out[name] = vals
    return out


def dequantized(arrays: dict, name: str) -> np.ndarray:
    if f"{name}_scale" not in arrays:
        return arrays[name].astype(np.float32)
    return arrays[name].astype(np.float32) * arrays[f"{name}_scale"][..., None, None, None]


def chunk_case(eng: Engine, key, rng):
    """A real chunk of bucket ``key``: a prefix of real pages in the
    bucket's last 4 (none for bucket 0), a ragged ``take`` in the chunk
    bucket's last 32 tokens and fresh pages for it; the pads are the
    first scratch page. Returns the reference's operands and the port's
    staged vector."""
    p_pad, c_pad = key
    T = eng.page_tokens
    sp = eng._scratch_pages[0]
    live = [p for p in range(eng.pool.k.shape[1]) if p not in eng._scratch_pages]
    p_real = int(rng.integers(p_pad - 3, p_pad + 1)) if p_pad else 0
    take = int(rng.integers(c_pad - eng.prefill_bucket + 1, c_pad + 1))
    pages = rng.permutation(live)
    prefix = pages[:p_real].tolist() + [sp] * (p_pad - p_real)
    w_real = -(-take // T)
    write = pages[p_real:p_real + w_real].tolist() + [sp] * (-(-c_pad // T) - w_real)
    tokens = rng.integers(2, eng.cfg.vocab_size, take).tolist() + [0] * (c_pad - take)
    pos0 = p_real * T
    return (dict(prefix=prefix, write=write, tokens=tokens, pos0=pos0, take=take),
            eng._pack(tokens, prefix, write, (pos0, take)))


def reference_chunk(jcfg, jparams, arrays, case, T):
    """The reference's jitted chunk step on ``arrays``; returns its logits
    and the pool arrays it returns, as numpy."""
    quantized = "k_scale" in arrays
    fn = _chunk_prefill_fn(jcfg, quantized)
    pages = [jnp.asarray(arrays["k"], jnp.int8 if quantized else jnp.bfloat16),
             jnp.asarray(arrays["v"], jnp.int8 if quantized else jnp.bfloat16)]
    if quantized:
        pages += [jnp.asarray(arrays["k_scale"]), jnp.asarray(arrays["v_scale"])]
    pos0, take = case["pos0"], case["take"]
    out = fn(jparams, *pages, jnp.asarray(case["prefix"], jnp.int32),
             jnp.asarray(case["write"], jnp.int32), jnp.asarray([case["tokens"]], jnp.int32),
             jnp.int32(pos0), jnp.int32(pos0), jnp.int32(take), jnp.int32(take - 1), T)
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    return np.asarray(out[0]), {n: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                              else a) for n, a in zip(names, out[1:])}


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_every_chunk_bucket_matches_the_reference_chunk_fn(qwen, fmt):
    cfg, params, jcfg, _, jparams = qwen
    eng = Engine(cfg, params, device="cpu", **SPEC_KW, device_format=fmt, offload_format=fmt)
    specs = [s for s in eng.warmup_specs(prefill_chunks=True) if s.kind == "chunk_prefill"]
    assert len(specs) == 6
    rng = np.random.default_rng(11)
    T = eng.page_tokens
    for i, spec in enumerate(specs):
        key = eng.spec_key(spec)
        arrays = seeded_pool(eng, seed=i)
        case, packed = chunk_case(eng, key, rng)
        logits, token = eng._chunk(key, packed)
        want_logits, want_pool = reference_chunk(jcfg, jparams, arrays, case, T)
        got = logits.numpy()
        np.testing.assert_allclose(got, want_logits, rtol=RTOL, atol=ATOL, err_msg=spec.name)
        rounded = np.asarray(jnp.asarray(want_logits, jnp.bfloat16).astype(jnp.float32))
        assert int(token) in set(np.flatnonzero(rounded == rounded.max()).tolist()), spec.name
        # what the step writes: the chunk's real pages (and the scratch
        # page, zeros); every other page keeps its bytes on both sides
        written = sorted(set(case["write"]))
        kept = [p for p in range(eng.pool.k.shape[1]) if p not in written]
        port = {n: getattr(eng.pool, n) for n in want_pool}
        for n, t in port.items():
            mine = t.float().numpy() if t.dtype != torch.int8 else t.numpy()
            np.testing.assert_array_equal(mine[:, kept], want_pool[n][:, kept], err_msg=n)
        port_np = {n: (t.float().numpy() if t.dtype != torch.int8 else t.numpy())
                   for n, t in port.items()}
        for n in ("k", "v"):
            a, b = dequantized(port_np, n)[:, written], dequantized(want_pool, n)[:, written]
            # the model band at each page's largest magnitude (the error
            # model of an int8 page, one scale a page), plus one int8 step
            amax = np.abs(b).max(axis=(2, 3, 4), keepdims=True)
            step = 0.0
            if fmt == "int8":
                step = np.maximum(port_np[f"{n}_scale"], want_pool[f"{n}_scale"])[
                    :, written][..., None, None, None]
            assert (np.abs(a - b) <= ATOL + RTOL * amax + step).all(), (spec.name, n)
        # the pad lanes wrote zeros to the scratch page
        sp = eng._scratch_pages[0]
        if sp in written:
            assert not eng.pool.k[:, sp].float().any()


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_warmed_chunked_follow_up_gives_reference_tokens(qwen, fmt):
    """Monolithic submits, then a follow-up over the cached prefix in
    16-token chunks (each with a prefix of its own) on a warmed engine:
    the reference engine's tokens, every chunk a replay of a bucket warmup
    captured."""
    cfg, params, jcfg, _, jparams = qwen
    kw = dict(ENGINE_KW, offload_format=fmt, device_format=fmt)
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.warmup(prefill_chunks=True)
    buckets = eng.chunk_graphs.keys()
    jeng = JaxEngine(jcfg, jparams, **kw)
    rng = np.random.default_rng(5)
    ctx = rng.integers(2, cfg.vocab_size, 29).tolist()
    for e, req in ((eng, EngineRequest), (jeng, JaxRequest)):
        e.submit(req("a", ctx, max_new_tokens=4))
    done, jdone = eng.run_to_completion()[0], jeng.run_to_completion()[0]
    check_engine_tokens(ctx, done.output_tokens, jdone.output_tokens, qwen, fmt)
    follow = ctx + done.output_tokens[:-1] + rng.integers(2, cfg.vocab_size, 45).tolist()
    job = eng.begin_submit(EngineRequest("a", follow, max_new_tokens=4))
    jjob = jeng.begin_submit(JaxRequest("a", follow, max_new_tokens=4))
    replays = eng.chunk_graphs.replays
    while not eng.prefill_step(job):
        assert not jeng.prefill_step(jjob)
    assert jeng.prefill_step(jjob)
    assert job.chunks_run == jjob.chunks_run >= 3
    assert eng.chunk_graphs.replays - replays == job.chunks_run
    assert eng.chunk_graphs.keys() == buckets
    c, jc = eng.run_to_completion()[0], jeng.run_to_completion()[0]
    assert (c.cached_tokens, c.prefilled_tokens) == (jc.cached_tokens, jc.prefilled_tokens)
    check_engine_tokens(follow, c.output_tokens, jc.output_tokens, qwen, fmt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq, Sp, lo, H, KH", [
    (64, 128, 100, 4, 4),        # the hole inside a 64-key tile
    (64, 128, 50, 4, 2),         # across the tile edge at 64, GQA
    (33, 192, 64, 2, 2),         # on the tile edge, a ragged chunk
    (16, 64, 0, 2, 1),           # the whole prefix in the hole, MQA
])
def test_blockwise_hole_tensor_lo_is_bit_equal_to_int(dtype, Sq, Sp, lo, H, KH):
    g = torch.Generator().manual_seed(Sq + Sp + lo)
    q = torch.randn((1, Sq, H, 32), generator=g).to(dtype)
    k, v = (torch.randn((1, Sp + Sq, KH, 32), generator=g).to(dtype) for _ in range(2))
    kw = dict(causal=True, q_offset=Sp, kv_block=64)
    want = blockwise_attention(q, k, v, kv_hole=(lo, Sp), **kw)
    got = blockwise_attention(q, k, v, kv_hole=(torch.tensor(lo, dtype=torch.int32), Sp), **kw)
    assert torch.equal(got, want)
    # the hole does mask: without it the result moves
    assert not torch.equal(blockwise_attention(q, k, v, **kw), want)


def test_prefill_with_tensor_offsets_is_bit_equal_to_ints(qwen):
    """A chunk over a padded prefix: ``positions_offset``, ``prefix_valid``
    and ``logit_index`` as 0-dim int32 tensors give the bits the ints
    give, logits and cache."""
    cfg, params = qwen[:2]
    model = Model(cfg, params)
    g = torch.Generator().manual_seed(4)
    L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    prefix = {n: torch.randn((L, 1, 64, KH, HD), generator=g).to(torch.bfloat16)
              for n in ("k", "v")}
    tokens = torch.randint(2, cfg.vocab_size, (1, 32), generator=g)
    ints = dict(positions_offset=48, prefix_valid=48, logit_index=20)
    want_logits, want_cache = model.prefill({"tokens": tokens}, prefix=prefix, **ints)
    got_logits, got_cache = model.prefill(
        {"tokens": tokens}, prefix=prefix,
        **{k: torch.tensor(v, dtype=torch.int32) for k, v in ints.items()})
    assert torch.equal(got_logits, want_logits)
    assert all(torch.equal(got_cache[n], want_cache[n]) for n in ("k", "v"))
    moved, _ = model.prefill({"tokens": tokens}, prefix=prefix,
                             **dict(ints, positions_offset=torch.tensor(47)))
    assert not torch.equal(moved, want_logits)


def test_vlm_prefill_with_tensor_offsets_is_bit_equal_to_ints():
    """The vlm family counts ``logit_index`` from the first text token,
    past its image embeddings, with a tensor as with an int."""
    cfg = get_config("internvl2-26b").reduced()
    model = Model(cfg, materialize(Model(cfg).describe(), seed=0))
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (1, 24), generator=g),
             "image_embeds": torch.randn((1, 8, cfg.d_model), generator=g)}
    want, _ = model.prefill(batch, logit_index=10, positions_offset=3)
    got, _ = model.prefill(batch, logit_index=torch.tensor(10, dtype=torch.int32),
                           positions_offset=torch.tensor(3, dtype=torch.int32))
    assert torch.equal(got, want)


def test_flash_wrapper_checks_a_device_hole_lo():
    """The kernel's operands for the hole: a host lower end as it is, a
    tensor one as its address (read on the device, nothing on the host),
    and anything else refused."""
    dev = torch.device("cpu")
    assert flash_ops._hole(None, dev) == (0, 0, None)
    assert flash_ops._hole((3, 8), dev) == (3, 8, None)
    lo = torch.tensor(3, dtype=torch.int32)
    assert flash_ops._hole((lo, 8), dev) == (0, 8, lo.data_ptr())
    with pytest.raises(ValueError, match="one int32"):
        flash_ops._hole((torch.tensor(3), 8), dev)
    with pytest.raises(ValueError, match="one int32"):
        flash_ops._hole((torch.tensor([3, 4], dtype=torch.int32), 8), dev)
    with pytest.raises(ValueError, match="one int32"):
        flash_ops._hole((lo, 8), torch.device("meta"))
    with pytest.raises(TypeError, match="upper end"):
        flash_ops._hole((lo, torch.tensor(8)), dev)


@pytest.fixture
def tracker(monkeypatch):
    """Armed, clean tracker, reset on the way out."""
    monkeypatch.setenv(compile_tracker.ENV_VAR, "1")
    t = compile_tracker.get_tracker()
    t.reset()
    yield t
    t.reset()
    t.disarm()


def test_chunk_bucket_met_after_warmup_fails_the_budget_gate(qwen, tracker):
    """An engine warmed with its chunk buckets replays a chunked corpus
    capturing nothing; one warmed without them captures each bucket it
    meets mid-replay, and the router's end-of-replay gate fails naming the
    chunk cache."""
    cfg, params = qwen[:2]
    corpus = [ProgramTrace(f"p{p}", [
        RequestRecord(input_tokens=30 + 17 * p + 9 * s, output_tokens=3,
                      tool_duration_s=0.0 if s == 1 else 4.0, reasoning_wall_s=0.0)
        for s in range(2)]) for p in range(2)]

    def replay(eng):
        router = MoriRouter([eng], scheduler="mori", chunked_prefill=True,
                            gpu_capacity_bytes=eng.radix_device_pages * eng.pool.page_bytes)
        return router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=3)

    warm = Engine(cfg, params, device="cpu", **SPEC_KW)
    warm.warmup(prefill_chunks=True)
    m = replay(warm)
    assert m.prefill_chunks > 0 and tracker.post_warmup_compiles() == {}
    assert warm.chunk_graphs.replays == 6 + m.prefill_chunks

    cold = Engine(cfg, params, device="cpu", **SPEC_KW)
    cold.warmup()
    name = f"engine{cold._audit_id}.chunk_prefill_graphs"
    with pytest.raises(RuntimeError, match="compile budget violated") as err:
        replay(cold)
    assert name in str(err.value)
    assert set(tracker.post_warmup_compiles()) == {name}
