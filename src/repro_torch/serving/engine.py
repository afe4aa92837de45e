"""The port's inference engine: paged KV + typed eviction, in PyTorch.

The counterpart of ``repro/serving/engine.py`` in its paged mode, the
execution plane the MORI scheduler drives:

* paged two-tier KV storage (:class:`repro_torch.serving.kvpool.PagePool`),
* RadixAttention-style prefix reuse via :class:`TypedRadixTree` — a new
  request whose prefix is cached skips prefill for those pages,
* **block-table decode**: the pool *is* the decode state. Each batched
  decode step runs the paged-attention kernel straight off the pool
  through per-slot block tables and appends the new token's KV into each
  slot's tail page in place,
* monolithic (``submit``) and chunked (``begin_submit``/``prefill_step``)
  prefill that write KV straight into pool pages,
* ``dense_slots=True``: the reference's pre-block-table decode path
  (JetStream-style fixed slot buffers ``[L, max_slots, max_seq, KH, HD]``),
  its benchmark baseline. The decode step reads the slot buffers with the
  same paged-attention kernel, each slot seen as ``max_seq / page_tokens``
  pages of its own; ``_finish`` copies full pages into the pool for the
  radix tree. It takes monolithic prefill only, and bf16 device pages.
* engine-level eviction that follows the scheduler's typed labels,
* program-level offload / reload / discard entry points used by the
  MORI router.

The reference compiles one ``jax.jit`` per shape bucket; the port
captures the decode step once per table bucket as a CUDA graph
(:class:`repro_torch.serving.graphs.StepGraphs`) and replays it.
:meth:`Engine.warmup_specs` lists the reference's buckets,
:meth:`Engine.spec_step` makes one runnable (what warmup runs and the step
auditor, :mod:`repro_torch.analysis.jitaudit`, traces),
:meth:`Engine.warmup` captures every decode bucket before traffic, and a
bucket first met later is captured then, which the compile tracker
(``REPRO_JITAUDIT=1``) counts as a post-warmup capture. The dense-slot
step has one shape, so one graph. A step stages its
inputs in one pinned host buffer, copies them to the bucket's static
buffer, replays, and reads back the greedy tokens the graph sampled. The
chunk prefill runs eagerly: its flash launch takes the chunk's offsets as
host integers. Where the reference donated buffers, the decode step and
the chunk prefill update the pool tensors in place. On the CPU the same
buckets run eagerly. The engine runs on the GPU unless the caller asks for
the CPU (``device="cpu"``); with no CUDA device it raises.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis import compile_tracker
from repro_torch.core.radix_tree import TypedRadixTree
from repro_torch.core.types import Tier, TypeLabel
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PAGED_FAMILIES, Model
from repro_torch.serving.kvpool import (
    PagePool,
    gather_token_run,
    gather_token_run_q,
    scatter_token_run,
    scatter_token_run_q,
)
from repro_torch.serving.graphs import StepGraphs

#: engine ids for the compile tracker's names, as the reference numbers them
_ENGINE_IDS = itertools.count()
#: the graph key of the dense-slot decode step (paged buckets are ints)
DENSE_KEY = "dense"


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device with no GPU present raises:
    nothing here carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_servable(cfg: ModelConfig) -> None:
    """The families :class:`Engine` serves: dense, moe and vlm without
    local/global alternation, as the reference's ``Engine`` asserts ("the
    real engine serves dense-cache families"). gemma2's alternation keeps
    two caches of another layout, zamba2's hybrid an SSM state beside its
    KV and whisper's encoder-decoder cross caches; :class:`Model` runs
    them, the paged engine serves none. vlm is admitted as the reference
    admits it, and fails alike at the first prefill: neither engine passes
    ``image_embeds``. Raises ``ValueError`` for any other configuration."""
    if cfg.family not in PAGED_FAMILIES or cfg.local_global_alternating:
        kind = "local/global alternation" if cfg.local_global_alternating else cfg.family
        raise ValueError(
            f"{cfg.name} ({kind}): the real engine serves dense-cache families "
            f"({'/'.join(PAGED_FAMILIES)} without local/global alternation)")


@dataclass
class EngineRequest:
    program_id: str
    tokens: list[int]            # full accumulated context (token ids)
    max_new_tokens: int = 16


@dataclass
class Completion:
    program_id: str
    output_tokens: list[int]
    cached_tokens: int           # tokens served from the radix cache
    prefilled_tokens: int        # tokens actually prefilled
    reloaded_pages: int


@dataclass
class PrefillJob:
    """A resumable chunked prefill: the two-phase twin of ``submit``.

    ``Engine.begin_submit`` reserves the decode slot, enters the
    radix-matched prefix pages and stages the suffix pages; each
    ``Engine.prefill_step`` call then prefills one page-aligned,
    budget-bounded chunk into the staged pages. ``first_token`` is set by
    the final chunk, at which point the job's slot is installed for decode.
    """

    request: EngineRequest
    slot_id: int
    suffix: list[int]            # tokens past the radix-cached prefix
    cached_tokens: int
    reloaded_pages: int
    prefix_pages: list[int]      # radix device pages (referenced, pinned)
    prefix_nodes: list
    new_pages: list[int]         # staged suffix pages (allocated up front)
    cursor: int = 0              # suffix tokens prefilled so far
    chunks_run: int = 0
    first_token: int | None = None
    kvsan_hold: int | None = None   # sanitizer hold token on new_pages

    @property
    def done(self) -> bool:
        return self.first_token is not None

    @property
    def remaining(self) -> int:
        return len(self.suffix) - self.cursor


@dataclass
class WarmupSpec:
    """One shape ``Engine.warmup`` runs before traffic: the reference's
    spec of the same name, kind, bucket and probe group.

    ``make_args`` is lazy, as in the reference: it builds the inputs at
    call time, on the engine's scratch pages or, for the ``dense`` spec,
    slot position 0. A ``dense`` or ``paged_decode`` spec's inputs are the
    step's staged int32 vector (:meth:`Engine._pack`); a
    ``chunk_prefill`` spec's are the keyword arguments of one eager
    chunk. ``probe_group`` names the structural equivalence class the
    reference's audit pairs specs by.
    """

    name: str
    kind: str                    # "dense" | "paged_decode" | "chunk_prefill"
    make_args: object            # () -> the spec's inputs
    bucket: dict = field(default_factory=dict)
    probe_group: str = ""


@dataclass
class SpecStep:
    """One warmup spec made runnable (:meth:`Engine.spec_step`).

    ``run`` is the step, a function of no arguments. ``buffers`` names the
    tensors the step must update in place and leave where they are (the
    pool's pages and scales, the dense slots, the bucket's staged input
    vector), read afresh at each call so that a rebinding shows."""

    run: object
    buffers: object


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic greedy sampling shared by every sample site.

    Logits are rounded to bf16 first, so sub-ulp differences between two
    paths that materialize the context differently become exact ties, and
    ``torch.argmax`` breaks exact ties by the lowest index — the sampled
    token is a function of the context, not of the code path."""
    return torch.argmax(logits.to(torch.bfloat16).to(torch.float32), dim=-1)


def _chunk_prefill(model: Model, pool: PagePool, prefix_idx, write_idx, tokens,
                   prefix_valid: int, pos0: int, take: int, logit_idx: int):
    """One chunk of prefill, pool in, pool updated in place. ``prefix_idx``
    is padded to a page bucket (its garbage tail masked via
    ``prefix_valid``); ``write_idx`` is padded with a scratch page; chunk
    KV past ``take`` is zeroed so the written tail page is byte-identical
    to the monolithic path's. Returns the logits at ``logit_idx``."""
    prefix = None
    if prefix_idx:
        if pool.quantized_device:
            pk, pv = gather_token_run_q(
                pool.k, pool.k_scale, pool.v, pool.v_scale, prefix_idx, torch.bfloat16
            )
        else:
            pk, pv = gather_token_run(pool.k, pool.v, prefix_idx)
        prefix = {"k": pk[:, None], "v": pv[:, None]}            # [L,1,Sp,KH,HD]
    logits, cache = model.prefill(
        {"tokens": tokens}, prefix=prefix, logit_index=logit_idx,
        positions_offset=pos0,
        prefix_valid=prefix_valid if prefix is not None else None,
    )
    k_c = cache["k"][:, 0]                                      # [L,C_pad,KH,HD]
    v_c = cache["v"][:, 0]
    k_c[:, take:] = 0
    v_c[:, take:] = 0
    if pool.quantized_device:
        scatter_token_run_q(
            pool.k, pool.k_scale, pool.v, pool.v_scale, write_idx, k_c, v_c,
            pool.page_tokens,
        )
    else:
        scatter_token_run(pool.k, pool.v, write_idx, k_c, v_c, pool.page_tokens)
    return logits[0]


@dataclass
class _Slot:
    request: EngineRequest
    slot_id: int
    length: int                  # current context length (incl. generated)
    produced: list[int] = field(default_factory=list)
    cached_tokens: int = 0
    prefilled_tokens: int = 0
    reloaded_pages: int = 0
    # block-table decode state: page ids covering positions [i*T, (i+1)*T);
    # entries below ``owned_from`` are shared radix pages (read-only,
    # pinned), entries from ``owned_from`` on are slot-owned
    table: list[int] = field(default_factory=list)
    owned_from: int = 0
    # the radix nodes backing table[:owned_from] — refcount-held for the
    # slot's lifetime so eviction/offload never recycles a page a live
    # block table points at
    prefix_nodes: list = field(default_factory=list)


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        device=None,
        page_tokens: int = 16,
        n_device_pages: int = 256,
        n_host_pages: int = 256,
        max_slots: int = 4,
        max_seq: int = 512,
        dense_slots: bool = False,
        table_bucket_pages: int = 4,
        prefill_bucket_tokens: int = 32,
        prefill_chunk_tokens: int = 64,
        offload_format: str = "bf16",
        device_format: str = "bf16",
    ):
        check_servable(cfg)
        if dense_slots and device_format == "int8":
            raise ValueError(
                "device_format='int8' packs the paged pool; the dense-slot "
                "path has no page-granular scale sidecars")
        if dense_slots and max_seq % page_tokens:
            raise ValueError(
                f"dense_slots needs max_seq ({max_seq}) to be a multiple of "
                f"page_tokens ({page_tokens}): the decode kernel reads each "
                "slot as whole pages")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the model holds ``params`` without copying them when they are
        # already on the device, so replicas share one set of weights
        self.model = Model(cfg, {
            k: _to_device(v, self.device) for k, v in params.items()
        })
        self.page_tokens = page_tokens
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.dense_slots = dense_slots
        # suffix prefill pads to this bucket, as the reference does;
        # causality keeps outputs identical
        self.prefill_bucket = max(1, prefill_bucket_tokens)
        # default per-call token budget for prefill_step (page-aligned there)
        self.prefill_chunk_tokens = max(1, prefill_chunk_tokens)
        self.pages_per_slot = -(-max_seq // page_tokens)
        # paged decode state lives IN the pool: pages_per_slot per slot plus
        # one scratch page per slot (inactive batch rows write their garbage
        # token there). The reserve is excluded from the router's
        # radix-capacity accounting via ``decode_reserve_pages``; the
        # dense-slot path keeps its decode state in the slot buffers.
        self.decode_reserve_pages = (
            0 if dense_slots else max_slots * (self.pages_per_slot + 1)
        )
        self.radix_device_pages = n_device_pages  # cache budget (sans reserve)
        self.pool = PagePool(
            layers=cfg.num_layers,
            kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            page_tokens=page_tokens,
            n_device_pages=n_device_pages + self.decode_reserve_pages,
            n_host_pages=n_host_pages,
            device=self.device,
            offload_format=offload_format,
            device_format=device_format,
        )
        self.quantized = self.pool.quantized_device
        self.tree = TypedRadixTree(page_tokens)
        if self.pool._san is not None:
            self.pool._san.tree = self.tree
            self.pool._san.add_reachable_cb(self._kvsan_reachable)
        self.lengths = np.zeros(max_slots, np.int32)
        self.last_token = np.zeros(max_slots, np.int32)
        # token whose KV currently occupies position lengths[sid]-1 — what a
        # step NOT advancing this slot re-feeds, so its row's write is an
        # idempotent rewrite of the existing tail KV
        self._tail_token = np.zeros(max_slots, np.int32)
        self.slots: dict[int, _Slot] = {}
        self._free_slots = list(range(max_slots))
        if dense_slots:
            L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
            self.slot_k = torch.zeros((L, max_slots, max_seq, KH, HD),
                                      dtype=torch.bfloat16, device=self.device)
            self.slot_v = torch.zeros_like(self.slot_k)
            self._scratch_pages: list[int] = []
        else:
            self._scratch_pages = [self.pool.alloc_device() for _ in range(max_slots)]
        self._table_bucket = table_bucket_pages
        # compile plane: one decode graph per table bucket (dense slots: one
        # graph), each over its bucket's staged inputs (``_staging``: a host
        # vector, pinned on the card so its copy is asynchronous, and the
        # static device vector the graph reads) and the pool's tensors or
        # slot buffers, which never move; ``_staged`` marks the last copy
        # out of a host vector
        self._audit_id = next(_ENGINE_IDS)
        self.graphs = StepGraphs(
            f"engine{self._audit_id}.{'decode' if dense_slots else 'paged_decode'}",
            self.device)
        self._staging: dict = {}             # graph key -> (host, static)
        self._staged = torch.cuda.Event() if self.device.type == "cuda" else None
        # metrics
        self.steps = 0
        self.evicted_pages = {"gpu": 0, "cpu": 0}
        # compile tracker (REPRO_JITAUDIT=1 only): register the hot-path
        # graph caches so post-warmup captures are attributable and gateable
        if compile_tracker.enabled():
            tracker = compile_tracker.get_tracker()
            for name, cache in self.graph_functions().items():
                tracker.register(name, cache)

    def _tensor(self, values, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    # ------------------------------------------------------- compile plane
    def graph_functions(self) -> dict:
        """The hot-path graph caches by tracker name: the counterpart of
        the reference's ``jit_functions``. The chunk prefill runs eagerly,
        so only the decode cache is listed."""
        if self.dense_slots:
            return {f"engine{self._audit_id}.decode_graphs": self.graphs}
        return {f"engine{self._audit_id}.paged_decode_graphs": self.graphs}

    def warmup_specs(self, prefill_chunks: bool = False) -> list[WarmupSpec]:
        """Every shape the serving hot path can dispatch, as lazy-argument
        specs: the reference's list, name for name.

        Paged decode emits one spec per table bucket (tables pad to
        ``table_bucket_pages``); chunked prefill one per (prefix-page
        bucket x chunk bucket) pair up to ``prefill_chunk_tokens``; the
        dense path a single shape. A replay that stays inside these specs
        captures nothing after warmup: the compile tracker's budget.
        """
        if self.dense_slots:
            return [WarmupSpec(
                name="decode_fn", kind="dense", make_args=self._scratch_dense_inputs,
                bucket={"max_slots": self.max_slots, "max_seq": self.max_seq},
                probe_group=f"engine{self._audit_id}/dense",
            )]
        n_buckets = -(-self.pages_per_slot // self._table_bucket)
        specs: list[WarmupSpec] = []
        for i in range(1, n_buckets + 1):
            p_pad = i * self._table_bucket
            specs.append(WarmupSpec(
                name=f"paged_decode_fn[pages={p_pad}]", kind="paged_decode",
                make_args=lambda p_pad=p_pad: self._scratch_decode_inputs(p_pad),
                bucket={"table_pages": p_pad},
                probe_group=f"engine{self._audit_id}/paged_decode",
            ))
        if not prefill_chunks:
            return specs
        T = self.page_tokens
        cap = max(T, (self.prefill_chunk_tokens // T) * T)
        cap_pad = -(-cap // self.prefill_bucket) * self.prefill_bucket
        sp = self._scratch_pages[0]

        def chunk_args(p_pad: int, c_pad: int):
            def make():
                return dict(
                    prefix_idx=[sp] * p_pad, write_idx=[sp] * -(-c_pad // T),
                    tokens=torch.zeros((1, c_pad), dtype=torch.long, device=self.device),
                    prefix_valid=0, pos0=0, take=c_pad, logit_idx=c_pad - 1,
                )

            return make

        for pb in range(n_buckets + 1):
            p_pad = pb * self._table_bucket
            # the prefix gather exists only when prefix pages do, so the
            # pb==0 bucket is a structurally different program
            group = "prefix" if p_pad else "no-prefix"
            for c_pad in range(self.prefill_bucket, cap_pad + 1, self.prefill_bucket):
                specs.append(WarmupSpec(
                    name=f"chunk_prefill_fn[prefix_pages={p_pad},chunk={c_pad}]",
                    kind="chunk_prefill", make_args=chunk_args(p_pad, c_pad),
                    bucket={"prefix_pages": p_pad, "chunk_tokens": c_pad},
                    probe_group=f"engine{self._audit_id}/chunk_prefill/{group}",
                ))
        return specs

    @torch.no_grad()
    def warmup(self, prefill_chunks: bool = False) -> None:
        """Capture every decode bucket before admitting traffic.

        Each table bucket's graph is captured and replayed once on the
        per-slot scratch pages, so serving never stops to capture when a
        batch first crosses a bucket boundary; the dense-slot path's one
        graph is captured on slot position 0. Must run on an idle engine
        (the dummy steps write garbage KV into the scratch pages or slot
        position 0, which the first real submit or step overwrites).
        ``prefill_chunks=True`` also runs every chunked-prefill bucket
        once, eagerly, against the scratch pages. When the compile tracker is armed (``REPRO_JITAUDIT=1``)
        the caches' sizes then become this engine's capture budget."""
        if self.slots:
            raise RuntimeError("warmup must run on an idle engine")
        tracker = compile_tracker.get_tracker()
        with tracker.phase("warmup"):
            for spec in self.warmup_specs(prefill_chunks=prefill_chunks):
                self.spec_step(spec).run()
        if compile_tracker.enabled():
            tracker.mark_warm(tuple(self.graph_functions()))

    def spec_step(self, spec: WarmupSpec, eager: bool = False) -> SpecStep:
        """``spec`` as a step to run: what :meth:`warmup` runs and the step
        auditor (:mod:`repro_torch.analysis.jitaudit`) traces. The spec's
        inputs are built now. A decode spec's step stages them and replays
        its bucket's graph, capturing it first if the bucket has none; with
        ``eager`` they are staged now into the bucket's static vector and
        the step is the function the graph captures, run op by op. A chunk
        spec's step is one eager chunk over the pool."""
        def pool_buffers() -> dict:
            return dict(zip(("k", "v", "k_scale", "v_scale"), self.pool.device_tensors()))

        args = spec.make_args()
        if spec.kind == "chunk_prefill":
            return SpecStep(lambda: _chunk_prefill(self.model, self.pool, **args),
                            pool_buffers)
        key = DENSE_KEY if spec.kind == "dense" else spec.bucket["table_pages"]

        def buffers() -> dict:
            out = ({"slot_k": self.slot_k, "slot_v": self.slot_v} if self.dense_slots
                   else pool_buffers())
            out["staged"] = self._staging[key][1]
            return out

        if not eager:
            return SpecStep(lambda: self._decode(key, args), buffers)
        return SpecStep(self._step_fn(key, self._stage(key, args)), buffers)

    def _pack(self, tokens, lengths, *paged) -> np.ndarray:
        """A decode step's inputs as one int32 vector, the layout of a
        bucket's staging buffers: ``[tokens | lengths]`` (``max_slots``
        each); for paged decode (``paged = (tail_pages, tail_offsets,
        tables)``) then the tail pages and offsets, and ``tables`` row by
        row."""
        return np.concatenate([
            np.asarray(a, np.int32).reshape(-1) for a in (tokens, lengths, *paged)
        ])

    def _scratch_dense_inputs(self) -> np.ndarray:
        """The dense step's inputs with every row at slot position 0:
        token 0 written there and attended alone."""
        B = self.max_slots
        return self._pack(np.zeros(B), np.ones(B))

    def _scratch_decode_inputs(self, p_pad: int) -> np.ndarray:
        """Bucket ``p_pad``'s decode inputs with every row on its own
        scratch page: token 0 written at position 0 and attended alone."""
        B = self.max_slots
        scratch = np.asarray(self._scratch_pages, np.int32)
        return self._pack(np.zeros(B), np.ones(B), scratch, np.zeros(B),
                          np.repeat(scratch[:, None], p_pad, axis=1))

    def _decode(self, key, packed: np.ndarray):
        """One decode step of table bucket ``key`` (the dense-slot step:
        :data:`DENSE_KEY`) over ``packed`` (:meth:`_pack`): stage it, replay
        the bucket's graph (capturing it first if the bucket has none) and
        return the graph's static ``(logits [B, V] f32, greedy tokens
        [B])``, valid until the next replay."""
        static = self._static(key, len(packed))
        if key not in self.graphs:
            self._capture_decode(key, static, packed)
        self._stage(key, packed)
        return self.graphs.replay(key)

    def _static(self, key, n: int) -> torch.Tensor:
        """Bucket ``key``'s static input vector of ``n`` int32, made at
        first use with its host vector: pinned on the card, so that the
        copy out of it is asynchronous."""
        if key not in self._staging:
            self._staging[key] = (
                torch.zeros(n, dtype=torch.int32, pin_memory=self.device.type == "cuda"),
                torch.zeros(n, dtype=torch.int32, device=self.device),
            )
        return self._staging[key][1]

    def _stage(self, key, packed: np.ndarray) -> torch.Tensor:
        """Copy ``packed`` into bucket ``key``'s static input vector through
        its host vector; returns the static vector."""
        static = self._static(key, len(packed))
        host = self._staging[key][0]
        if self._staged is not None:
            # the last asynchronous copy out of a staging buffer has been
            # read before any staging buffer is written again
            self._staged.synchronize()
        host.numpy()[:] = packed
        static.copy_(host, non_blocking=True)
        if self._staged is not None:
            self._staged.record()
        return static

    def _step_fn(self, key, static: torch.Tensor):
        """Bucket ``key``'s decode step over its static input vector
        ``static``, as a function of no arguments: what its graph
        captures."""
        if key == DENSE_KEY:
            return lambda: self.decode_dense(static)
        return lambda: self.decode_packed(static, key)

    def _capture_decode(self, key, static: torch.Tensor, packed: np.ndarray) -> None:
        """Capture bucket ``key``'s decode step over ``static``. The
        capture's eager run on the card reads ``static``, so it is filled
        first: for a paged bucket with the warmup spec's scratch-page
        inputs; for the dense-slot step with the step's own inputs
        ``packed``, whose eager run rewrites the KV each row's replay then
        writes again, the same values at the same positions (and, on an
        idle engine, slot position 0)."""
        static.copy_(torch.from_numpy(
            packed if key == DENSE_KEY else self._scratch_decode_inputs(key)))
        self.graphs.capture(key, self._step_fn(key, static))

    def decode_dense(self, staged: torch.Tensor, slot_tensors=None):
        """The dense-slot decode step run op by op: the function its graph
        captures. ``staged`` is a device int32 vector ``[tokens |
        lengths]``; ``slot_tensors`` the k and v slot buffers it writes and
        reads, by default the engine's own. Returns the logits ``[B, V]``
        f32 and the greedy tokens ``[B]``."""
        toks, lens = staged.view(2, self.max_slots)
        k, v = slot_tensors or (self.slot_k, self.slot_v)
        logits = self.model.decode_into({"k": k, "v": v}, toks.long(), lens,
                                        page_tokens=self.page_tokens)
        return logits, greedy_token(logits)

    def decode_packed(self, staged: torch.Tensor, p_pad: int, pool_tensors=None):
        """The decode step of table bucket ``p_pad`` run op by op: the
        function a bucket's graph captures. ``staged`` is a device int32
        vector in :meth:`_pack`'s layout; ``pool_tensors`` the k, v (and,
        int8-resident, the scales) it reads and appends to, by default
        the pool's own (:meth:`PagePool.device_tensors`). Returns the
        logits ``[B, V]`` f32 and the greedy tokens ``[B]``."""
        B = self.max_slots
        toks, lens, tails, offs = staged[: 4 * B].view(4, B)
        k, v, *scales = pool_tensors or self.pool.device_tensors()
        logits = self.model.decode_paged(
            k, v, toks.long(), lens, staged[4 * B:].view(B, p_pad), tails, offs,
            *(scales or (None, None)),
        )
        return logits, greedy_token(logits)

    # ------------------------------------------------------------- kvsan
    def _kvsan_reachable(self):
        """Live page references outside the radix tree, for the sanitizer:
        per-slot scratch pages and every resident block table (none in
        the dense-slot path)."""
        out = [("dev", p, "scratch") for p in self._scratch_pages]
        for slot in self.slots.values():
            pid = slot.request.program_id
            for p in slot.table:
                out.append(("dev", p, f"block table of {pid}"))
        return out

    def _san_scope(self, tag: str) -> None:
        if self.pool._san is not None:
            self.pool._san.set_scope(tag)

    # ------------------------------------------------------------ admission
    def free_slot_count(self) -> int:
        """Decode slots currently available for ``submit`` — the real
        occupancy signal the scheduler's slot probe reads."""
        return len(self._free_slots)

    def _check_request(self, req: EngineRequest) -> None:
        if not self._free_slots:
            raise RuntimeError("no free decode slots")
        if len(req.tokens) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request of {len(req.tokens)} tokens + {req.max_new_tokens} new "
                f"exceeds max_seq={self.max_seq}"
            )

    def _alloc_suffix_pages(self, n_have: int, length: int, nodes, pid: str,
                            sid: int) -> list[int]:
        """Allocate the slot-owned pages past the cached prefix; on failure
        roll back the pins and the slot and re-raise."""
        T = self.page_tokens
        new_pages: list[int] = []
        try:
            for _ in range(n_have, -(-length // T)):
                new_pages.append(self._alloc_decode_page())
        except RuntimeError:
            for page in new_pages:
                self.pool.free_device(page)
            self.tree.release_nodes(nodes)
            self.tree.unpin(pid)
            self._free_slots.append(sid)
            raise
        return new_pages

    @torch.no_grad()
    def submit(self, req: EngineRequest) -> int:
        """Admit one request: radix match -> reload -> monolithic prefill."""
        self._check_request(req)
        pid = req.program_id
        self._san_scope(f"submit:{pid}")

        # 1. promote any host-resident prefix pages back to the device
        reloaded = self._reload_prefix(req.tokens)
        # 2. device-resident prefix
        nodes = self.tree.match_prefix(req.tokens)
        cached = len(nodes) * self.page_tokens
        pages = [n.device_page for n in nodes]
        suffix = req.tokens[cached:]
        if not suffix:
            raise ValueError("request must extend its cached prefix")

        # pin before touching the pool: suffix-page allocation may evict,
        # and the prefix chain a block table points at must survive (the
        # dense-slot path copies the prefix into its slot and holds none)
        self.tree.pin(pid)
        if not self.dense_slots:
            self.tree.acquire_nodes(nodes)

        prefix = None
        if pages:
            pk, pv = self.pool.read_device_pages(pages)
            prefix = {"k": pk[:, None], "v": pv[:, None]}       # [L,1,Sp,KH,HD]

        pad = (-len(suffix)) % self.prefill_bucket
        tokens = self._tensor([suffix + [0] * pad], torch.long)
        logits, cache = self.model.prefill(
            {"tokens": tokens}, prefix=prefix, logit_index=len(suffix) - 1,
        )
        first_token = int(greedy_token(logits[0]))

        # 3. install into a decode slot
        sid = self._free_slots.pop()
        length = len(req.tokens)
        slot = _Slot(
            request=req,
            slot_id=sid,
            length=length,
            produced=[first_token],
            cached_tokens=cached,
            prefilled_tokens=len(suffix),
            reloaded_pages=reloaded,
        )
        k_suf = cache["k"][:, 0, : len(suffix)]                 # [L,Ssuf,KH,HD]
        v_suf = cache["v"][:, 0, : len(suffix)]
        if self.dense_slots:
            # the slot holds the whole context: cached prefix, then suffix
            k_ctx, v_ctx = k_suf, v_suf
            if prefix is not None:
                k_ctx = torch.cat([prefix["k"][:, 0], k_ctx], dim=1)
                v_ctx = torch.cat([prefix["v"][:, 0], v_ctx], dim=1)
            self.slot_k[:, sid, :length] = k_ctx
            self.slot_v[:, sid, :length] = v_ctx
        else:
            # block-table install: reference the cached prefix pages and
            # write the suffix KV straight into freshly allocated pages
            new_pages = self._alloc_suffix_pages(len(pages), length, nodes, pid, sid)
            slot.table = list(pages) + new_pages
            slot.owned_from = len(pages)
            slot.prefix_nodes = nodes
            self.pool.write_device_pages(new_pages, k_suf, v_suf)
        self.lengths[sid] = length
        self.last_token[sid] = first_token
        self._tail_token[sid] = req.tokens[-1]  # prefill wrote its KV last
        self.slots[sid] = slot
        return sid

    # --------------------------------------------------- chunked prefill
    def begin_submit(self, req: EngineRequest) -> PrefillJob:
        """Phase one of a chunked submit: radix match -> reload -> reserve.

        Reserves a decode slot, pins the matched prefix chain, and stages
        every suffix page up front. No model compute runs here. On
        allocation failure all state is rolled back and the RuntimeError
        propagates, as in ``submit``. The dense-slot path refuses it.
        """
        if self.dense_slots:
            raise RuntimeError("chunked prefill requires the paged engine")
        self._check_request(req)
        pid = req.program_id
        self._san_scope(f"begin_submit:{pid}")

        reloaded = self._reload_prefix(req.tokens)
        nodes = self.tree.match_prefix(req.tokens)
        cached = len(nodes) * self.page_tokens
        pages = [n.device_page for n in nodes]
        suffix = req.tokens[cached:]
        if not suffix:
            raise ValueError("request must extend its cached prefix")

        self.tree.pin(pid)
        self.tree.acquire_nodes(nodes)
        sid = self._free_slots.pop()
        new_pages = self._alloc_suffix_pages(len(pages), len(req.tokens), nodes, pid, sid)
        hold = None
        if self.pool._san is not None:
            # the staged suffix pages belong to this job until the final
            # chunk installs them into a slot's block table
            hold = self.pool._san.add_hold("dev", new_pages, f"prefill job:{pid}")
        return PrefillJob(
            request=req,
            slot_id=sid,
            suffix=suffix,
            cached_tokens=cached,
            reloaded_pages=reloaded,
            prefix_pages=pages,
            prefix_nodes=nodes,
            new_pages=new_pages,
            kvsan_hold=hold,
        )

    @torch.no_grad()
    def prefill_step(self, job: PrefillJob, token_budget: int | None = None) -> bool:
        """Run ONE bucketed prefill chunk of at most ``token_budget`` tokens
        (page-aligned; default ``prefill_chunk_tokens``). Returns True when
        the final chunk lands, at which point ``job.first_token`` is set and
        the slot is installed for decode.

        The chunk pads to ``prefill_bucket`` tokens and the page-gathered
        prefix pads to the table bucket (tail masked via ``prefix_valid``),
        the same shapes the reference computes on.
        """
        if job.done:
            raise RuntimeError("prefill job already completed")
        if job.remaining <= 0:
            raise RuntimeError("prefill job was cancelled")
        T = self.page_tokens
        budget = self.prefill_chunk_tokens if token_budget is None else token_budget
        cap = max(T, (budget // T) * T)          # page-aligned chunk ceiling
        take = min(job.remaining, cap)
        c_pad = -(-take // self.prefill_bucket) * self.prefill_bucket
        scratch = self._scratch_pages[job.slot_id]

        # prefix for this chunk: radix pages + suffix pages already written
        # (the cursor is page-aligned on every chunk but the last)
        prefix_pages = job.prefix_pages + job.new_pages[: job.cursor // T]
        p_real = len(prefix_pages)
        p_pad = -(-p_real // self._table_bucket) * self._table_bucket
        prefix_idx = prefix_pages + [scratch] * (p_pad - p_real)

        # staged pages this chunk writes, padded to the bucketed width with
        # the slot's scratch page (pad lanes scatter zeros — harmless)
        w0 = job.cursor // T
        w_real = -(-take // T)
        w_pad = -(-c_pad // T)
        write_idx = job.new_pages[w0 : w0 + w_real]
        write_idx = write_idx + [scratch] * (w_pad - len(write_idx))

        chunk = job.suffix[job.cursor : job.cursor + take]
        tokens = self._tensor([chunk + [0] * (c_pad - take)], torch.long)
        pos0 = job.cached_tokens + job.cursor    # absolute chunk start
        logits = _chunk_prefill(
            self.model, self.pool, prefix_idx, write_idx, tokens,
            prefix_valid=pos0, pos0=pos0, take=take, logit_idx=take - 1,
        )
        job.cursor += take
        job.chunks_run += 1
        if job.cursor < len(job.suffix):
            return False
        job.first_token = int(greedy_token(logits))
        self._install_job(job)
        return True

    def _install_job(self, job: PrefillJob) -> None:
        """Final chunk landed: install the job's slot for decode."""
        req = job.request
        sid = job.slot_id
        length = len(req.tokens)
        if job.kvsan_hold is not None:
            # ownership moves to the slot's block table
            self.pool._san.drop_hold(job.kvsan_hold)
            job.kvsan_hold = None
        self.slots[sid] = _Slot(
            request=req,
            slot_id=sid,
            length=length,
            produced=[job.first_token],
            cached_tokens=job.cached_tokens,
            prefilled_tokens=len(job.suffix),
            reloaded_pages=job.reloaded_pages,
            table=list(job.prefix_pages) + list(job.new_pages),
            owned_from=len(job.prefix_pages),
            prefix_nodes=job.prefix_nodes,
        )
        self.lengths[sid] = length
        self.last_token[sid] = job.first_token
        self._tail_token[sid] = req.tokens[-1]

    def cancel_prefill(self, job: PrefillJob) -> None:
        """Abort a mid-flight prefill job: free the staged pages, release
        the pinned prefix chain and return the reserved slot."""
        if job.done:
            raise RuntimeError("job already installed; retire via decode")
        self._san_scope(f"cancel_prefill:{job.request.program_id}")
        if job.kvsan_hold is not None:
            self.pool._san.drop_hold(job.kvsan_hold)
            job.kvsan_hold = None
        for page in job.new_pages:
            self.pool.free_device(page)
        self.tree.release_nodes(job.prefix_nodes)
        self.tree.unpin(job.request.program_id)
        self._free_slots.append(job.slot_id)
        self.lengths[job.slot_id] = 0
        job.cursor = len(job.suffix)  # poison: no further prefill_step

    def _reload_prefix(self, tokens: list[int]) -> int:
        """Promote host-resident prefix pages to the device, best-effort.

        Stops at the first failed reload: pages past the break point cannot
        extend the *device-resident* prefix chain. The chain is
        refcount-pinned while it streams so ``_ensure_device_page`` can
        never evict a later chain node to make room for an earlier one.
        """
        chain = self.tree.match_prefix_any_tier(tokens)
        self.tree.acquire_nodes(chain)
        n = 0
        try:
            for node in chain:
                if node.device_page is not None:
                    continue
                try:
                    self._ensure_device_page()
                except RuntimeError:
                    break            # pool exhausted and nothing evictable
                dp = self.pool.reload_page(node.host_page)
                if dp is None:
                    break
                node.host_page = None
                node.device_page = dp
                n += 1
        finally:
            self.tree.release_nodes(chain)
        return n

    def _alloc_decode_page(self) -> int:
        """One device page for decode state (evicting cold cache if needed).

        Decode-state pages are funded by the pool's decode reserve, so the
        radix-cache budget is NOT consulted here; eviction only kicks in
        when the pool is genuinely out of free pages."""
        self._ensure_device_page(cache_page=False)
        page = self.pool.alloc_device()
        if page is None:
            raise RuntimeError("device pool exhausted and nothing evictable")
        return page

    # -------------------------------------------------------------- decode
    def step(self, active: "list[int] | None" = None) -> list[Completion]:
        """One continuous-batching decode step across the active slots.

        ``active`` selects which resident slots advance this step (default:
        all of them). Masked slots stay in the batch but their state is
        untouched: their lengths are not bumped and their row re-feeds the
        token whose KV already occupies the tail position
        (``_tail_token``), so the step's write is an idempotent rewrite of
        existing KV and the sampled token for those rows is discarded.
        """
        if not self.slots:
            return []
        if active is None:
            active_ids = list(self.slots)
        else:
            active_ids = [sid for sid in active if sid in self.slots]
            if not active_ids:
                return []
        self.steps += 1
        active_set = set(active_ids)
        toks_np = self.last_token.copy()
        for sid in self.slots:
            if sid in active_set:
                # this step writes last_token's KV at the new tail position
                self._tail_token[sid] = self.last_token[sid]
                self.lengths[sid] += 1  # the decoded token extends the ctx
            else:
                # masked: rewrite the existing tail KV instead of clobbering
                # it with the (not-yet-written) last token's
                toks_np[sid] = self._tail_token[sid]
        lens = np.maximum(self.lengths, 1)
        if self.dense_slots:
            next_tok = self._dense_step(toks_np, lens)
        else:
            next_tok = self._paged_step(toks_np, lens)
        done: list[Completion] = []
        for sid, slot in list(self.slots.items()):
            if sid not in active_set:
                continue
            slot.length = int(self.lengths[sid])
            tok = int(next_tok[sid])
            slot.produced.append(tok)
            self.last_token[sid] = tok
            if len(slot.produced) >= slot.request.max_new_tokens:
                done.append(self._finish(slot))
        return done

    @torch.no_grad()
    def _dense_step(self, toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Dense-slot decode through its graph: every row writes its token's
        KV at ``lens - 1`` of its slot and attends over the slot's first
        ``lens`` positions (a free slot: position 0). Returns the sampled
        token of every batch row."""
        _, next_tok = self._decode(DENSE_KEY, self._pack(toks, lens))
        return next_tok.cpu().numpy()

    @torch.no_grad()
    def _paged_step(self, toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Block-table decode: attend via tables, append KV to tail pages,
        through the table bucket's graph. Returns the sampled token of
        every batch row."""
        T = self.page_tokens
        for sid, slot in self.slots.items():
            pos = int(self.lengths[sid]) - 1    # this step's write position
            if pos // T == len(slot.table):     # tail page rolled over
                slot.table.append(self._alloc_decode_page())
        san = self.pool._san
        if san is not None:
            san.set_scope(f"step#{self.steps}")
            for sid, slot in self.slots.items():
                san.check_table(
                    slot.table, int(self.lengths[sid]) - 1,
                    slot.request.program_id,
                )
        # tables are padded to a bucketed page count, as in the reference;
        # padding names page 0, which the kernel never reads (only
        # ``lengths`` decides what is visible)
        p_used = max(len(s.table) for s in self.slots.values())
        p_pad = -(-p_used // self._table_bucket) * self._table_bucket
        B = self.max_slots
        tables = np.zeros((B, p_pad), np.int32)
        tail_pages = np.zeros(B, np.int32)
        tail_offsets = np.zeros(B, np.int32)
        for sid in range(B):
            slot = self.slots.get(sid)
            if slot is None:
                # inactive batch row: attend over (and write to) its private
                # scratch page — never a live page
                tables[sid, :] = self._scratch_pages[sid]
                tail_pages[sid] = self._scratch_pages[sid]
            else:
                tables[sid, : len(slot.table)] = slot.table
                pos = int(self.lengths[sid]) - 1
                tail_pages[sid] = slot.table[pos // T]
                tail_offsets[sid] = pos % T
        _, next_tok = self._decode(
            p_pad, self._pack(toks, lens, tail_pages, tail_offsets, tables))
        return next_tok.cpu().numpy()

    def _finish(self, slot: _Slot) -> Completion:
        """Persist the slot's full pages into the radix tree, free the slot.

        Paged mode hands the already-resident pages over by id (zero copy).
        Dense mode copies slot data into freshly allocated pool pages, as
        far as the pool has room.
        """
        req = slot.request
        self._san_scope(f"finish:{req.program_id}")
        all_tokens = req.tokens + slot.produced[:-1]  # last token has no KV yet
        T = self.page_tokens
        n_full = len(all_tokens) // T
        have = len(self.tree.match_prefix(all_tokens))
        # retire the slot FIRST: the duplicate/tail frees below release
        # pages its block table still lists
        self.slots.pop(slot.slot_id)
        self._free_slots.append(slot.slot_id)
        self.lengths[slot.slot_id] = 0
        if self.dense_slots:
            new_pages = []
            for p in range(have, n_full):
                self._ensure_device_page()
                page = self.pool.alloc_device()
                if page is None:
                    break
                lo, hi = p * T, (p + 1) * T
                self.pool.write_device_pages(
                    [page],
                    self.slot_k[:, slot.slot_id, lo:hi],
                    self.slot_v[:, slot.slot_id, lo:hi],
                )
                new_pages.append(page)
            covered = (have + len(new_pages)) * T
        else:
            # duplicates of pages another program inserted first, plus the
            # partially filled tail page, go back to the free list; the
            # rest transfer ownership to the tree in place
            new_pages = slot.table[have:n_full]
            for p in range(slot.owned_from, have):
                self.pool.free_device(slot.table[p])
            if len(all_tokens) % T and n_full < len(slot.table):
                self.pool.free_device(slot.table[n_full])
            covered = n_full * T
            self.tree.release_nodes(slot.prefix_nodes)
        self.tree.unpin(req.program_id)  # release the pages pinned at submit
        self.tree.insert_chain(
            all_tokens[:covered], new_pages, req.program_id, TypeLabel.BUSY
        )
        # budget enforcement happens where the cache GROWS: handing decode
        # pages to the tree may push it past radix_device_pages
        while self._cache_over_budget() and self._evict_one_cache_page():
            pass
        return Completion(
            program_id=req.program_id,
            output_tokens=slot.produced,
            cached_tokens=slot.cached_tokens,
            prefilled_tokens=slot.prefilled_tokens,
            reloaded_pages=slot.reloaded_pages,
        )

    def run_to_completion(self, max_steps: int = 10_000) -> list[Completion]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.slots:
                break
        return out

    # ---------------------------------------------- typed eviction machinery
    def _cache_over_budget(self) -> bool:
        """Is the radix cache at/over its device-page budget? (The paged
        pool is over-provisioned by ``decode_reserve_pages`` for decode
        state; the dense-slot pool holds the cache alone and is never over
        budget.)"""
        if self.dense_slots:
            return False
        return self.tree.stats()["device_pages"] >= self.radix_device_pages

    def _ensure_device_page(self, cache_page: bool = True) -> None:
        """Free one device page if the pool is exhausted (typed order) or
        a *cache-growing* allocation would push the radix cache past its
        budget (``cache_page=False`` for decode-state pages)."""
        over_budget = cache_page and self._cache_over_budget()
        if self.pool.device_free_count() > 0 and not over_budget:
            return
        if self._evict_one_cache_page():
            return
        if self.pool.device_free_count() > 0:
            # over cache budget but every cached page is pinned by live
            # decodes: degrade into the reserve headroom rather than fail
            return
        raise RuntimeError("device pool exhausted and nothing evictable")

    def _evict_one_cache_page(self) -> bool:
        """Spill the best victim page to host (typed order); False if every
        cached page is pinned."""
        for node in self.tree.evictable("gpu"):
            dp = node.device_page
            hp = self.pool.offload_page(dp)  # spill to host if possible
            if hp is not None:
                node.device_page = None
                node.host_page = hp
            else:
                node.device_page = None
                self.pool.free_device(dp)
                self.tree._gc(node)
            self.evicted_pages["gpu"] += 1
            return True
        return False

    def _ensure_host_page(self) -> None:
        if self.pool.host_free_count() > 0:
            return
        for node in self.tree.evictable("cpu"):
            self.pool.free_host(self.tree.evict(node, "cpu"))
            self.evicted_pages["cpu"] += 1
            return

    # --------------------------------------------- MORI program-level verbs
    def offload_program(self, pid: str) -> int:
        """GPU -> host for all of the program's device pages. Returns count."""
        self._san_scope(f"offload_program:{pid}")
        n = 0
        for node in reversed(self.tree.program_nodes(pid)):  # leaves first
            if node.device_page is not None and node.refcount == 0:
                self._ensure_host_page()
                hp = self.pool.offload_page(node.device_page)
                if hp is None:
                    break
                node.device_page = None
                node.host_page = hp
                n += 1
        return n

    def reload_program(self, pid: str) -> int:
        """Host -> GPU for all of the program's pages. Returns count.

        The chain is refcount-held while it streams, so the budget
        eviction inside ``_ensure_device_page`` cannot pick the
        just-reloaded nodes of this very program as victims."""
        self._san_scope(f"reload_program:{pid}")
        nodes = self.tree.program_nodes(pid)
        self.tree.acquire_nodes(nodes)
        n = 0
        try:
            for node in nodes:
                if node.device_page is None and node.host_page is not None:
                    self._ensure_device_page()
                    dp = self.pool.reload_page(node.host_page)
                    if dp is None:
                        break
                    node.host_page = None
                    node.device_page = dp
                    n += 1
        finally:
            self.tree.release_nodes(nodes)
        return n

    def discard_program(self, pid: str, tier: Tier) -> None:
        self._san_scope(f"discard_program:{pid}:{tier.value}")
        for node in reversed(self.tree.program_nodes(pid)):
            if node.refcount > 0:
                continue
            if tier is Tier.GPU and node.device_page is not None:
                self.pool.free_device(node.device_page)
                node.device_page = None
            if tier is Tier.CPU and node.host_page is not None:
                self.pool.free_host(node.host_page)
                node.host_page = None
            self.tree._gc(node)
        if not any(
            n.device_page is not None or n.host_page is not None
            for n in self.tree.program_nodes(pid)
        ):
            self.tree.release_program(pid)

    def set_label(self, pid: str, label: TypeLabel) -> None:
        self.tree.restamp(pid, label)

    def abort_request(self, pid: str) -> EngineRequest | None:
        """Tear down a mid-decode slot without persisting its KV — the
        failover path: the router requeues the returned request and a
        healthy replica re-prefills the identical context. Slot-owned
        pages go back to the free list; the shared prefix chain keeps its
        pages and just drops this slot's holds."""
        slot = next(
            (s for s in self.slots.values() if s.request.program_id == pid), None
        )
        if slot is None:
            return None
        self._san_scope(f"abort_request:{pid}")
        # retire the slot FIRST (same reachability rationale as _finish)
        self.slots.pop(slot.slot_id)
        self._free_slots.append(slot.slot_id)
        self.lengths[slot.slot_id] = 0
        if not self.dense_slots:
            for page in slot.table[slot.owned_from:]:
                self.pool.free_device(page)
            self.tree.release_nodes(slot.prefix_nodes)
        self.tree.unpin(pid)
        return slot.request


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
