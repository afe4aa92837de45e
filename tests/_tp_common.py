"""What the two sides of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_serving.py`` share: the engine and router settings,
the contexts, the corpus, the kernel cases and the serving suite's
configurations, engines and inputs. Plain Python and numpy: the
reference's subprocess (``_tp_reference.py``) and the port's ranks
(``_tp_ranks.py``) each build their own objects from these."""
from __future__ import annotations

import numpy as np

#: the mesh both sides serve on: one data row, a model axis of two
MESH = (1, 2)
ARCH = "qwen1.5-0.5b"
#: the GQA layout whose KV heads the model axis does not divide: the rules
#: replicate the KV while the query heads stay sharded
GQA = dict(num_heads=6, num_kv_heads=3)

#: the engine settings of ``tests/test_torch_dist.py``'s placement test
ENGINE_KW = dict(page_tokens=8, n_device_pages=48, n_host_pages=32, max_slots=2,
                 max_seq=128, prefill_bucket_tokens=16, prefill_chunk_tokens=16)
NEW_TOKENS = 5

#: the router's engines and budgets, as ``tests/test_torch_router.py``'s pump
ROUTER_ENGINE_KW = dict(page_tokens=8, n_device_pages=96, n_host_pages=64, max_slots=3,
                        max_seq=192)
ROUTER_NEW_TOKENS = 4


def contexts(vocab: int) -> dict:
    rng = np.random.default_rng(0)
    return {"a": rng.integers(2, vocab, 37).tolist(), "b": rng.integers(2, vocab, 20).tolist()}


def corpus(trace_cls, record_cls):
    """Three busy programs whose windows align, and one whose long tool
    call gets it demoted and reloaded (``tests/test_torch_router.py``)."""
    busy = [
        trace_cls(f"p{i}", [
            record_cls(40 + 4 * i, 4, 1.0, reasoning_wall_s=2.0),
            record_cls(52 + 4 * i, 4, 0.0, reasoning_wall_s=2.0),
        ])
        for i in range(3)
    ]
    idle = trace_cls("p3", [
        record_cls(56, 4, 30.0, reasoning_wall_s=2.0),
        record_cls(72, 4, 0.0, reasoning_wall_s=2.0),
    ])
    return busy + [idle]


def router_kw(kvb: int, transfer_cost_cls, scheduler_config_cls) -> dict:
    """The pump's router settings: a budget tight enough that the idle
    program is offloaded and reloaded, async transfers on a priced link,
    migration under pressure on."""
    return dict(scheduler="mori", gpu_capacity_bytes=100 * kvb,
                config=scheduler_config_cls(tick_interval_s=1.0, migrate_on_pressure=True),
                xfer_cost=transfer_cost_cls(pcie_bytes_per_s=64 * kvb / 12.0,
                                            ssd_bytes_per_s=32 * kvb / 12.0))


def faults(fault_plan_cls) -> list:
    """Replica 1 fails at t = 2 s of the router's clock and recovers at
    10 s: its programs' pages migrate to replica 0 (one migration of 7
    pages in this corpus) and the drain runs once."""
    return [fault_plan_cls(replica=1, fail_at=2.0, recover_at=10.0)]


class PlanRecorder:
    """Wraps a scheduler (of either package) and collects every action its
    plan-returning events emit, as the router tests' harness does."""

    EVENTS = frozenset({"request_arrived", "request_completed", "tick", "program_finished",
                        "replica_failed", "on_transfer_complete"})

    def __init__(self, sched):
        self.sched = sched
        self.actions: list = []

    def __getattr__(self, name):
        attr = getattr(self.sched, name)
        if name not in self.EVENTS:
            return attr

        def wrapped(*args, **kwargs):
            plan = attr(*args, **kwargs)
            self.actions.extend(plan.actions)
            return plan

        return wrapped


#: kernel cases under ``local_map``: (name, B, H, KH, D); the last is the
#: GQA layout the model axis does not divide
KERNEL_CASES = [("mha", 2, 4, 4, 64), ("gqa", 2, 8, 2, 64), ("gqa_kv_replicated", 2, 6, 3, 64)]
PAGE_TOKENS, PAGES_PER_SEQ = 8, 6
PREFILL_S, PREFIX_S = 40, 24


def kernel_inputs(case) -> dict:
    """The numpy inputs of one kernel case, in f32 (rounded to bf16 by
    both sides): a paged decode (the new token's KV beside the pool) and
    a prefill over a prefix with a hole."""
    name, B, H, KH, D = case
    rng = np.random.default_rng(sum(map(ord, name)))
    T, P = PAGE_TOKENS, PAGES_PER_SEQ
    N = B * P + 1
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(
        q=f(B, H, D), k_new=f(B, KH, D), v_new=f(B, KH, D),
        k_pages=f(N, T, KH, D), v_pages=f(N, T, KH, D),
        tables=rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(np.int32),
        lengths=np.array([P * T - 3, T + 2][:B], np.int32),
        pq=f(1, PREFILL_S, H, D), pk=f(1, PREFIX_S + PREFILL_S, KH, D),
        pv=f(1, PREFIX_S + PREFILL_S, KH, D))


# ------------------------------------------------- the serving suite
#: the serving suite's configurations: (architecture, overrides of its
#: reduced config). Reduced dbrx-132b has 4 query heads over 1 KV head (the
#: model axis does not divide it: the KV fallback); its ``kv2`` variant
#: shards 2 KV heads; reduced arctic-480b adds the dense residual FFN
SERVING_CONFIGS = {
    "qwen": (ARCH, {}),
    "dbrx": ("dbrx-132b", {}),
    "dbrx_kv2": ("dbrx-132b", {"num_kv_heads": 2}),
    "arctic": ("arctic-480b", {}),
}

#: the int8 formats of both tiers, and dense slots with int8 offload on a
#: pool small enough that finished programs' pages are offloaded
INT8 = dict(offload_format="int8", device_format="int8")
DENSE_SLOTS = dict(dense_slots=True, offload_format="int8", n_device_pages=6)

#: the serving suite's engines on the mesh: name -> (configuration, engine
#: keywords over ``ENGINE_KW``, chunked prefill)
SERVING_ENGINES = {
    "qwen int8 monolithic": ("qwen", INT8, False),
    "qwen int8 chunked": ("qwen", INT8, True),
    "qwen dense_slots": ("qwen", DENSE_SLOTS, False),
    "dbrx monolithic": ("dbrx", {}, False),
    "dbrx chunked": ("dbrx", {}, True),
    "dbrx_kv2 monolithic": ("dbrx_kv2", {}, False),
    "dbrx_kv2 chunked": ("dbrx_kv2", {}, True),
    "arctic monolithic": ("arctic", {}, False),
}


def engine_kw(name: str) -> dict:
    """``ENGINE_KW`` with the serving engine ``name``'s keywords."""
    return {**ENGINE_KW, **SERVING_ENGINES[name][1]}


def kv_rows(engine, ctxs: dict, served: dict, sids: dict) -> dict:
    """Where each served program's KV lies in ``engine`` (of either
    package): the decode slot it had and the device page of each full page
    of its context in the radix tree (``None`` for a page on the host)."""
    return {pid: {"slot": sids[pid], "pages": [
        n.device_page for n in engine.tree.match_prefix_any_tier(ctx + served[pid][:-1])]}
        for pid, ctx in ctxs.items()}


#: the quantize sites held one page each: the prefill's scatter into an
#: int8 pool, the decode commit's requantize, the int8 offload's host copy
QUANT_SITES = ("prefill", "decode", "offload")
#: a quantize case's pool: layers, page tokens, KV heads (split two ways),
#: head dim; the prefill's run spans one page and 3 tokens of the next
QUANT_SHAPE = dict(L=2, T=8, KH=4, HD=64)
QUANT_RUN = 11


def quant_inputs() -> dict:
    """The quantize cases' tokens ``[L, S, KH, HD]`` (f32, rounded to bf16
    by both sides), the decode's new token ``[L, 1, KH, HD]`` and its
    offset in the page. Each layer scales one half of the heads up, the
    first half in layer 0 and the second in layer 1, so a page's amax lies
    on either rank."""
    L, KH, HD = QUANT_SHAPE["L"], QUANT_SHAPE["KH"], QUANT_SHAPE["HD"]
    rng = np.random.default_rng(5)
    scale = np.ones((L, 1, KH, 1), np.float32)
    scale[0, :, : KH // 2] = scale[1, :, KH // 2:] = 3.0
    x = rng.standard_normal((L, QUANT_RUN, KH, HD)).astype(np.float32) * scale
    new = rng.standard_normal((L, 1, KH, HD)).astype(np.float32) * 4.0 * scale
    return dict(k=x, v=-0.5 * x, new_k=new, new_v=-new, offset=np.array([5], np.int64))


#: the MoE layer alone, in f32 on bit-equal inputs: (configuration, B, S)
MOE_CASES = [("dbrx", 3, 1), ("dbrx", 2, 24), ("arctic", 2, 24)]


def moe_input(case) -> np.ndarray:
    name, B, S = case
    rng = np.random.default_rng(B * 100 + S)
    return rng.standard_normal((B, S, 256)).astype(np.float32)


# ------------------------------------------------- the train suite
#: the meshes the train suite trains on: FSDP over "data", then tensor
#: parallel over "model"
TRAIN_MESHES = ((2, 1), (1, 2))
#: the launcher's data settings at a reduced size: 2 microbatches of 2 rows
TRAIN_DATA = dict(seq_len=32, global_batch=4)
TRAIN_STEPS = 3
TRAIN_MICRO = 2
#: every (configuration, mesh, dtype) the suite holds against the
#: reference: f32 trains TRAIN_STEPS steps, bf16 takes the step-1 gradient
TRAIN_CASES = [(name, mesh, dtype) for dtype in ("f32", "bf16") for name in ("qwen", "gqa")
               for mesh in TRAIN_MESHES]


def train_key(name: str, mesh, dtype: str) -> str:
    return f"{name} {mesh[0]}x{mesh[1]} {dtype}"


# ------------------------------------------------- the MoE train suite
#: the MoE train suite's configurations: name -> architecture, each at its
#: reduced size (dbrx: 4 query heads over 1 KV head, the KV replicated
#: over "model"; arctic: the dense residual FFN beside the experts)
TRAIN_MOE_CONFIGS = {"dbrx": "dbrx-132b", "arctic": "arctic-480b"}
#: every (configuration, mesh, dtype) the MoE suite holds against the
#: reference, as ``TRAIN_CASES``
TRAIN_MOE_CASES = [(name, mesh, dtype) for dtype in ("f32", "bf16")
                   for name in TRAIN_MOE_CONFIGS for mesh in TRAIN_MESHES]
#: the MoE layer alone under autograd: rows and positions of its input
MOE_GRAD_SHAPE = (4, 16)


def moe_grad_inputs(d_model: int) -> dict:
    """The layer-level gradient case's input ``x`` and the weights ``w``
    of ``(apply_moe(x) * w).sum() + aux`` (f32)."""
    rng = np.random.default_rng(11)
    shape = (*MOE_GRAD_SHAPE, d_model)
    return {"x": rng.standard_normal(shape).astype(np.float32),
            "w": rng.standard_normal(shape).astype(np.float32)}


# ------------------------------------------------- the SSM train suite
#: the SSM train suite's configurations: name -> architecture, each at its
#: reduced size (mamba2: 4 Mamba-2 blocks of 16 SSD heads; zamba2: 2 groups
#: of 2 Mamba-2 blocks, each group followed by the shared attention block)
TRAIN_SSM_CONFIGS = {"mamba2": "mamba2-2.7b", "zamba2": "zamba2-2.7b"}
#: every (configuration, mesh, dtype) the SSM suite holds against the
#: reference, as ``TRAIN_CASES``
TRAIN_SSM_CASES = [(name, mesh, dtype) for dtype in ("f32", "bf16")
                   for name in TRAIN_SSM_CONFIGS for mesh in TRAIN_MESHES]
#: the Mamba-2 block alone under autograd: rows and positions of its input
SSM_GRAD_SHAPE = (4, 32)
#: model level on ``MESH`` under the decode rules: prompt rows and tokens,
#: teacher-forced decode steps after the prefill, zamba2's shared slots
SSM_PROMPT = (2, 24)
SSM_DECODE_STEPS = 4
SSM_MAX_SEQ = 32
#: every (configuration, dtype) held at model level
SSM_MODEL_CASES = [(name, dtype) for name in TRAIN_SSM_CONFIGS for dtype in ("f32", "bf16")]


def ssm_grad_inputs(d_model: int) -> dict:
    """The block-level gradient case's input ``x`` and the weights ``w``
    of ``(apply_mamba_block(x) * w).sum()`` (f32)."""
    rng = np.random.default_rng(12)
    shape = (*SSM_GRAD_SHAPE, d_model)
    return {"x": rng.standard_normal(shape).astype(np.float32),
            "w": rng.standard_normal(shape).astype(np.float32)}


def ssm_tokens(vocab: int) -> dict:
    """The model-level case's prompt ``[rows, tokens]`` and the tokens fed
    at each decode step ``[steps, rows]``."""
    rng = np.random.default_rng(13)
    return {"prompt": rng.integers(2, vocab, SSM_PROMPT).astype(np.int64),
            "steps": rng.integers(2, vocab, (SSM_DECODE_STEPS, SSM_PROMPT[0])).astype(np.int64)}


def ssm_key(name: str, dtype: str) -> str:
    return f"{name} model {dtype}"


# ------------------------------------------------- the families suite
#: the families suite's configurations: name -> architecture, each at its
#: reduced size (gemma2: 2 (local, global) pairs, 4 query heads over 2 KV
#: heads, window 64, softcaps 50 and 30; whisper: 2 encoder and 4 decoder
#: layers of 4 heads over 24 encoder positions; internvl2: 4 query heads
#: over 1 KV head, which the model axis does not divide, and 8 image
#: tokens)
TRAIN_FAMILY_CONFIGS = {"gemma2": "gemma2-9b", "whisper": "whisper-medium",
                        "internvl2": "internvl2-26b"}
#: gemma2 trains on sequences longer than its reduced window, so that the
#: local layers' window binds
TRAIN_DATA_OF = {"gemma2": dict(seq_len=96, global_batch=4)}
#: gemma2 through both ``Trainer``s, as ``TRAIN_CASES``
GEMMA2_TRAIN_CASES = [("gemma2", mesh, dtype) for dtype in ("f32", "bf16")
                      for mesh in TRAIN_MESHES]
#: ``Model.loss`` and its gradient, for the families whose ``Trainer``
#: feeds no frames or images: (configuration, mesh, dtype)
LOSS_CASES = [(name, mesh, dtype) for dtype in ("f32", "bf16") for name in ("whisper", "internvl2")
              for mesh in TRAIN_MESHES]
#: a loss case's rows and tokens (the text, plus the label shift)
LOSS_BATCH = (4, 33)
#: model level on ``MESH`` under the decode rules: prompt rows and tokens
#: (gemma2's longer than its window of 64, so that its ring wraps), the
#: teacher-forced decode steps, the slots (gemma2's global ones; its local
#: ring holds ``RING_SLOTS``, the window)
FAMILY_PROMPT = {"gemma2": (2, 80), "whisper": (2, 16), "internvl2": (2, 24)}
FAMILY_DECODE_STEPS = 4
FAMILY_MAX_SEQ = 96
RING_SLOTS = 64
#: every (configuration, dtype) held at model level
FAMILY_MODEL_CASES = [(name, dtype) for name in TRAIN_FAMILY_CONFIGS for dtype in ("f32", "bf16")]
#: the block-level cases: gemma2's (local, global) pair and whisper's
#: decoder block under autograd, rows and positions of their input (the
#: pair's longer than the window), whisper's encoder positions
BLOCK_SHAPE = {"gemma2": (4, 80), "whisper": (4, 16)}
BLOCK_CASES = [(name, mesh) for name in BLOCK_SHAPE for mesh in TRAIN_MESHES]


def family_inputs(name: str, cfg, rows: int, tokens: int, seed: int) -> dict:
    """A batch of ``name``: ``tokens`` [rows, tokens] (int64), whisper's
    ``frames`` [rows, encoder_seq, d] and internvl2's ``image_embeds``
    [rows, num_image_tokens, d] (f32; each package casts them)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab_size, (rows, tokens)).astype(np.int64)}
    if name == "whisper":
        out["frames"] = rng.standard_normal((rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if name == "internvl2":
        out["image_embeds"] = rng.standard_normal(
            (rows, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def loss_inputs(name: str, cfg) -> dict:
    return family_inputs(name, cfg, *LOSS_BATCH, seed=21)


def family_prompt(name: str, cfg) -> dict:
    """The model-level case's prompt batch and the tokens fed at each
    decode step (``steps`` [steps, rows])."""
    rows, n = FAMILY_PROMPT[name]
    out = family_inputs(name, cfg, rows, n, seed=22)
    rng = np.random.default_rng(23)
    out["steps"] = rng.integers(2, cfg.vocab_size, (FAMILY_DECODE_STEPS, rows)).astype(np.int64)
    return out


def prompt_length(name: str, cfg) -> int:
    """The positions a prefill of ``name``'s prompt fills (internvl2's
    count its image tokens)."""
    return FAMILY_PROMPT[name][1] + (cfg.num_image_tokens if name == "internvl2" else 0)


def block_inputs(name: str, cfg) -> dict:
    """The block-level case's input ``x`` and output weights ``w`` (and
    whisper's encoder output ``enc``), f32."""
    rng = np.random.default_rng(24)
    B, S = BLOCK_SHAPE[name]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {"x": f(B, S, cfg.d_model), "w": f(B, S, cfg.d_model)}
    if name == "whisper":
        out["enc"] = f(B, cfg.encoder_seq, cfg.d_model)
    return out


def family_key(name: str, dtype: str) -> str:
    return f"{name} model {dtype}"
