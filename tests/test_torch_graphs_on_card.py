"""Step graphs on the card: a replay against the same step run eagerly.

For every table bucket of a reduced qwen engine, on a bf16 and an int8
pool, the replayed decode step's logits and greedy tokens equal an eager
``Model.decode_paged`` on a clone of the pool bit for bit, and so do the
pool bytes each writes; each replay runs one paged-attention kernel a
layer on the device (``torch.profiler``, and the kernel's own count on
the device) and calls no wrapper. So does
every bucket's MoE decode graph of a reduced dbrx-132b engine. The
reduced mamba2 decode graph equals ``Model.decode_into`` on a clone of
the state, logits and state, bit for bit. ``PagePool.adopt`` copies into
the pool's tensors, so the next replay reads the adopted bytes. Every
chunk-prefill bucket's graph, on a bf16 and an int8 pool, with a real
prefix and a ragged chunk, equals ``Engine.chunk_packed`` on a clone of
the pool, logits, token and pool bit for bit, each replay one flash
kernel a layer by the kernel's own count on the device.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package::

    python -m pytest -q -m cuda tests/test_torch_graphs_on_card.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, EngineRequest, SsmEngine

#: the serving engine's table geometry: 16-token pages, max_seq 384, so 24
#: pages a slot in buckets of 4
ENGINE_KW = dict(page_tokens=16, n_device_pages=40, n_host_pages=8, max_slots=3, max_seq=384)
BUCKETS = list(range(4, 25, 4))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: step graphs capture CUDA kernels")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    return cfg, materialize(Model(cfg).describe(), seed=0)


def random_pool(eng, rng) -> None:
    """Fill the pool with values a real context would hold."""
    pool = eng.pool
    for t in (pool.k, pool.v):
        if pool.quantized_device:
            vals = rng.integers(-127, 128, t.shape, dtype=np.int8)
        else:
            vals = rng.standard_normal(t.shape, dtype=np.float32)
        t.copy_(torch.from_numpy(vals))
    if pool.quantized_device:
        for s in (pool.k_scale, pool.v_scale):
            s.copy_(torch.from_numpy(rng.uniform(0.002, 0.02, s.shape).astype(np.float32)))


def bucket_inputs(eng, p_pad: int, rng) -> np.ndarray:
    """Staged inputs of one step in bucket ``p_pad``: every row's length in
    the bucket's last four pages, distinct pages across rows."""
    B, T = eng.max_slots, eng.page_tokens
    lengths = rng.integers((p_pad - 4) * T + 1, p_pad * T + 1, B)
    live = [p for p in range(eng.pool.k.shape[1]) if p not in eng._scratch_pages]
    tables = rng.permutation(live)[: B * p_pad].reshape(B, p_pad)
    tail = tables[np.arange(B), (lengths - 1) // T]
    tokens = rng.integers(0, eng.cfg.vocab_size, B)
    return eng._pack(tokens, lengths, tail, (lengths - 1) % T, tables)


@torch.no_grad()
def eager_step(eng, packed: np.ndarray, p_pad: int, tensors: list):
    """The decode step run op by op on ``tensors`` (a pool's k, v and
    scales)."""
    return eng.decode_packed(torch.from_numpy(packed).to(eng.device), p_pad, tensors)


#: profiles of one run before a short profiler count fails
PROFILES = 2


def paged_kernels_run(fn, card):
    """``fn()`` under ``torch.profiler``: returns ``(fn's result, the
    paged kernels the profiler saw, the paged kernels the device ran)``,
    the first counting ``paged_split_kernel`` records (one a launch), the
    second the kernel's own count on the device. A profile has come back
    short of the device's count though every launch ran (1 of 4 kernels
    once), so a short profile runs ``fn`` once more under a new one;
    ``fn`` must give the same result when run again. A profile short on
    its last run fails."""
    for attempt in range(1, PROFILES + 1):
        counted = paged_ops.KERNEL.device_launches(card)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        ran = paged_ops.KERNEL.device_launches(card) - counted
        seen = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and "paged_split_kernel" in ev.key)
        if seen >= ran:
            return result, seen, ran
    pytest.fail(f"{PROFILES} profiles saw fewer paged kernels than the device ran: "
                f"{seen} < {ran} on the last")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_every_bucket_replays_the_eager_step_bit_for_bit(card, qwen, fmt):
    cfg, params = qwen
    eng = Engine(cfg, params, device=card, device_format=fmt, offload_format=fmt, **ENGINE_KW)
    random_pool(eng, np.random.default_rng(40))
    eng.warmup()
    assert eng.graphs.keys() == BUCKETS
    rng = np.random.default_rng(41)
    for p_pad in BUCKETS:
        packed = bucket_inputs(eng, p_pad, rng)
        clones = [t.clone() for t in eng.pool.device_tensors()]
        launches = paged_ops.KERNEL.launches
        (logits, tokens), seen, ran = paged_kernels_run(
            lambda: [t.clone() for t in eng._decode(p_pad, packed)], card)
        assert seen == cfg.num_layers, (p_pad, seen)
        assert ran == cfg.num_layers
        assert paged_ops.KERNEL.launches == launches      # the replay called no wrapper
        want_logits, want_tokens = eager_step(eng, packed, p_pad, clones)
        torch.cuda.synchronize()
        assert torch.equal(logits, want_logits), (p_pad, (logits - want_logits).abs().max())
        assert torch.equal(tokens, want_tokens), p_pad
        for got, want in zip(eng.pool.device_tensors(), clones):
            assert torch.equal(got, want), p_pad


#: the chunk buckets of ENGINE_KW with the launcher's prefill bucket (32)
#: and chunk (64): prefix pages 0 to 24 in steps of 4, chunks of 32 and 64
CHUNK_BUCKETS = [(p, c) for p in range(0, 25, 4) for c in (32, 64)]


def chunk_inputs(eng, key, rng) -> np.ndarray:
    """Staged inputs of one chunk in bucket ``key``: a prefix of real pages
    in the bucket's last four (none in bucket 0) padded with a scratch
    page, a ragged ``take`` in the chunk bucket's last 32 tokens written to
    fresh pages."""
    p_pad, c_pad = key
    T, sp = eng.page_tokens, eng._scratch_pages[0]
    live = [p for p in range(eng.pool.k.shape[1]) if p not in eng._scratch_pages]
    p_real = int(rng.integers(p_pad - 3, p_pad + 1)) if p_pad else 0
    take = int(rng.integers(c_pad - 31, c_pad + 1))
    pages = rng.permutation(live)
    w_real = -(-take // T)
    return eng._pack(
        rng.integers(2, eng.cfg.vocab_size, take).tolist() + [0] * (c_pad - take),
        pages[:p_real].tolist() + [sp] * (p_pad - p_real),
        pages[p_real:p_real + w_real].tolist() + [sp] * (-(-c_pad // T) - w_real),
        (p_real * T, take))


def check_chunk_graphs(eng, card, buckets, seed: int) -> None:
    """Each chunk bucket's replay against ``Engine.chunk_packed`` on a clone
    of the pool: logits, the greedy token and every pool tensor bit for
    bit; the replay runs one flash kernel a layer on the device and calls
    no wrapper."""
    rng = np.random.default_rng(seed)
    for key in buckets:
        packed = chunk_inputs(eng, key, rng)
        clones = [t.clone() for t in eng.pool.device_tensors()]
        launches = flash_ops.KERNEL.launches
        counted = flash_ops.KERNEL.device_launches(card)
        logits, token = (t.clone() for t in eng._chunk(key, packed))
        assert flash_ops.KERNEL.device_launches(card) - counted == eng.cfg.num_layers, key
        assert flash_ops.KERNEL.launches == launches, key      # no wrapper ran
        with torch.no_grad():
            want_logits, want_token = eng.chunk_packed(
                torch.from_numpy(packed).to(card), key, clones)
        torch.cuda.synchronize()
        assert torch.equal(logits, want_logits), (key, (logits - want_logits).abs().max())
        assert torch.equal(token, want_token), key
        for got, want in zip(eng.pool.device_tensors(), clones):
            assert torch.equal(got, want), key


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_every_chunk_bucket_replays_the_eager_step_bit_for_bit(card, qwen, fmt):
    """The chunk prefill captured per (prefix-page bucket x chunk bucket)
    with a real prefix and a ragged chunk, on a bf16 and an int8 pool."""
    cfg, params = qwen
    eng = Engine(cfg, params, device=card, device_format=fmt, offload_format=fmt, **ENGINE_KW)
    random_pool(eng, np.random.default_rng(46))
    eng.warmup(prefill_chunks=True)
    assert eng.graphs.keys() == BUCKETS
    assert eng.chunk_graphs.keys() == CHUNK_BUCKETS
    check_chunk_graphs(eng, card, CHUNK_BUCKETS, seed=47)
    assert eng.chunk_graphs.keys() == CHUNK_BUCKETS


@pytest.mark.cuda
def test_dbrx_decode_graphs_replay_the_eager_step_bit_for_bit(card):
    """The MoE decode step (router top-k, capacity positions and the expert
    products, all on the device) captured per table bucket of a reduced
    dbrx-132b engine at its real capacity factor, against the eager step."""
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(), capacity_factor=1.25)
    eng = Engine(cfg, materialize(Model(cfg).describe(), seed=0), device=card, **ENGINE_KW)
    random_pool(eng, np.random.default_rng(42))
    eng.warmup()
    assert eng.graphs.keys() == BUCKETS
    rng = np.random.default_rng(43)
    for p_pad in BUCKETS:
        packed = bucket_inputs(eng, p_pad, rng)
        clones = [t.clone() for t in eng.pool.device_tensors()]
        (logits, tokens), seen, ran = paged_kernels_run(
            lambda: [t.clone() for t in eng._decode(p_pad, packed)], card)
        assert seen == cfg.num_layers, (p_pad, seen)
        assert ran == cfg.num_layers
        want_logits, want_tokens = eager_step(eng, packed, p_pad, clones)
        torch.cuda.synchronize()
        assert torch.equal(logits, want_logits), (p_pad, (logits - want_logits).abs().max())
        assert torch.equal(tokens, want_tokens), p_pad
        for got, want in zip(eng.pool.device_tensors(), clones):
            assert torch.equal(got, want), p_pad


@pytest.mark.cuda
def test_after_adopt_the_replay_reads_the_adopted_bytes(card, qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, device=card, **ENGINE_KW)
    random_pool(eng, np.random.default_rng(42))
    eng.warmup()
    pool = eng.pool
    tensors = pool.device_tensors()
    packed = bucket_inputs(eng, 8, np.random.default_rng(43))
    before = eager_step(eng, packed, 8, [t.clone() for t in tensors])[0]
    # new values for every page: a replay over the old bytes would differ
    adopted = [t.clone() for t in tensors]
    for t in adopted:
        t.mul_(-0.5)
    pool.adopt(*adopted)
    assert all(a is b for a, b in zip(pool.device_tensors(), tensors))
    clones = [t.clone() for t in adopted]
    logits, _ = eng._decode(8, packed)
    torch.cuda.synchronize()
    assert eng.graphs.keys() == BUCKETS            # no capture: the graphs stay valid
    want, _ = eager_step(eng, packed, 8, clones)
    assert torch.equal(logits, want)
    assert not torch.equal(logits, before)
    for got, w in zip(pool.device_tensors(), clones):
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_engine_serves_through_its_graphs(card, qwen):
    """Two requests to completion on a warmed engine: one replay a step,
    the paged kernel launched by the replays only. A second profile (see
    :func:`paged_kernels_run`) serves the same two prompts again under new
    program ids."""
    cfg, params = qwen
    eng = Engine(cfg, params, device=card, **ENGINE_KW)
    eng.warmup()
    rng = np.random.default_rng(44)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (70, 200)]
    captured = eng.graphs.keys()
    runs = iter(range(PROFILES))

    def serve():
        run = next(runs)
        for pid, prompt in zip("ab", prompts):
            eng.submit(EngineRequest(f"{pid}{run}", prompt, max_new_tokens=6))
        replays, steps, launches = eng.graphs.replays, eng.steps, paged_ops.KERNEL.launches
        done = eng.run_to_completion()
        return (run, done, eng.graphs.replays - replays, eng.steps - steps,
                paged_ops.KERNEL.launches - launches)

    (run, done, replays, steps, launches), seen, ran = paged_kernels_run(serve, card)
    assert sorted(c.program_id for c in done) == [f"a{run}", f"b{run}"]
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.output_tokens)
    assert eng.graphs.keys() == captured
    assert replays == steps == 5
    assert launches == 0
    assert seen == ran == cfg.num_layers * steps


@pytest.mark.cuda
def test_dense_slot_graph_replays_the_eager_step_bit_for_bit(card, qwen):
    """``Engine(dense_slots=True)``: one decode graph over the slot
    buffers, against ``Engine.decode_dense`` on clones of them; the replay
    runs one paged kernel a layer over the slots seen as pages."""
    cfg, params = qwen
    eng = Engine(cfg, params, device=card, dense_slots=True, **ENGINE_KW)
    rng = np.random.default_rng(45)
    for t in (eng.slot_k, eng.slot_v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, dtype=np.float32)))
    eng.warmup()
    assert eng.graphs.keys() == ["dense"]
    for _ in range(3):
        lengths = rng.integers(1, eng.max_seq + 1, eng.max_slots)
        packed = eng._pack(rng.integers(0, cfg.vocab_size, eng.max_slots), lengths)
        clones = [eng.slot_k.clone(), eng.slot_v.clone()]
        (logits, tokens), seen, ran = paged_kernels_run(
            lambda: [t.clone() for t in eng._decode("dense", packed)], card)
        assert seen == cfg.num_layers
        assert ran == cfg.num_layers
        want_logits, want_tokens = eng.decode_dense(
            torch.from_numpy(packed).to(card), clones)
        torch.cuda.synchronize()
        assert torch.equal(logits, want_logits), (logits - want_logits).abs().max()
        assert torch.equal(tokens, want_tokens)
        assert torch.equal(eng.slot_k, clones[0]) and torch.equal(eng.slot_v, clones[1])
    assert eng.graphs.keys() == ["dense"]


@pytest.mark.cuda
def test_mamba_decode_graph_replays_the_eager_step_bit_for_bit(card):
    cfg = get_config("mamba2-2.7b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    eng = SsmEngine(cfg, params, device=card)
    eng.warmup()
    toks = torch.from_numpy(np.random.default_rng(45).integers(2, cfg.vocab_size, (1, 37)))
    _, cache = eng.model.prefill({"tokens": toks.to(card)})
    eng._load_state(cache)
    state = {k: t.clone() for k, t in eng._state.items()}
    for tok in (5, 77, 300, 9):
        logits = eng._step_tokens(tok).clone()
        want = eng.model.decode_into(state, torch.tensor([tok], device=card))[0]
        torch.cuda.synchronize()
        assert torch.equal(logits, want), tok
        for k in state:
            assert torch.equal(eng._state[k], state[k]), (tok, k)
    assert eng.graphs.replays == 4 and eng.graphs.keys() == ["decode"]
    # and the bundle it started from is untouched
    _, again = eng.model.prefill({"tokens": toks.to(card)})
    for k in cache:
        assert torch.equal(cache[k], again[k])
