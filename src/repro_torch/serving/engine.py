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
* engine-level eviction that follows the scheduler's typed labels,
* program-level offload / reload / discard entry points used by the
  MORI router.

PyTorch runs eagerly, so the reference's ``jax.jit`` functions, warmup
specs, compile tracking and buffer donation have no counterpart: the
decode step and the chunk prefill update the pool tensors in place. The
suffix and prefix buckets are kept, so the port computes on the same
shapes as the reference. The engine runs on the GPU unless the caller
asks for the CPU (``device="cpu"``); with no CUDA device it raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.radix_tree import TypedRadixTree
from repro_torch.core.types import Tier, TypeLabel
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.kvpool import (
    PagePool,
    gather_token_run,
    gather_token_run_q,
    scatter_token_run,
    scatter_token_run_q,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device with no GPU present raises:
    nothing here carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


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
        table_bucket_pages: int = 4,
        prefill_bucket_tokens: int = 32,
        prefill_chunk_tokens: int = 64,
        offload_format: str = "bf16",
        device_format: str = "bf16",
    ):
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
        # suffix prefill pads to this bucket, as the reference does;
        # causality keeps outputs identical
        self.prefill_bucket = max(1, prefill_bucket_tokens)
        # default per-call token budget for prefill_step (page-aligned there)
        self.prefill_chunk_tokens = max(1, prefill_chunk_tokens)
        self.pages_per_slot = -(-max_seq // page_tokens)
        # decode state lives IN the pool: pages_per_slot per slot plus one
        # scratch page per slot (inactive batch rows write their garbage
        # token there). The reserve is excluded from the router's
        # radix-capacity accounting via ``decode_reserve_pages``.
        self.decode_reserve_pages = max_slots * (self.pages_per_slot + 1)
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
        self._scratch_pages = [self.pool.alloc_device() for _ in range(max_slots)]
        self._table_bucket = table_bucket_pages
        # metrics
        self.steps = 0
        self.evicted_pages = {"gpu": 0, "cpu": 0}

    def _tensor(self, values, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- kvsan
    def _kvsan_reachable(self):
        """Live page references outside the radix tree, for the sanitizer:
        per-slot scratch pages and every resident block table."""
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
        # and the prefix chain a block table points at must survive
        self.tree.pin(pid)
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

        # 3. install into a decode slot: reference the cached prefix pages
        # and write the suffix KV straight into freshly allocated pages
        sid = self._free_slots.pop()
        length = len(req.tokens)
        new_pages = self._alloc_suffix_pages(len(pages), length, nodes, pid, sid)
        slot = _Slot(
            request=req,
            slot_id=sid,
            length=length,
            produced=[first_token],
            cached_tokens=cached,
            prefilled_tokens=len(suffix),
            reloaded_pages=reloaded,
            table=list(pages) + new_pages,
            owned_from=len(pages),
            prefix_nodes=nodes,
        )
        k_suf = cache["k"][:, 0, : len(suffix)]                 # [L,Ssuf,KH,HD]
        v_suf = cache["v"][:, 0, : len(suffix)]
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
        propagates, as in ``submit``.
        """
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
        next_tok = self._paged_step(
            self._tensor(toks_np, torch.long),
            self._tensor(np.maximum(self.lengths, 1)),
        )
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
    def _paged_step(self, toks, lens) -> np.ndarray:
        """Block-table decode: attend via tables, append KV to tail pages.
        Returns the sampled token of every batch row."""
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
        k_pages, v_pages = self.pool.block_table_view()
        k_scales, v_scales = self.pool.scale_view()
        logits = self.model.decode_paged(
            k_pages, v_pages, toks, lens, self._tensor(tables),
            self._tensor(tail_pages), self._tensor(tail_offsets),
            k_scales, v_scales,
        )
        return greedy_token(logits).cpu().numpy()

    def _finish(self, slot: _Slot) -> Completion:
        """Persist the slot's full pages into the radix tree, free the slot.

        The already-resident pages are handed over by id (zero copy).
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
        # duplicates of pages another program inserted first, plus the
        # partially filled tail page, go back to the free list; the rest
        # transfer ownership to the tree in place
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
        """Is the radix cache at/over its device-page budget? (The pool is
        over-provisioned by ``decode_reserve_pages`` for decode state.)"""
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
        for page in slot.table[slot.owned_from:]:
            self.pool.free_device(page)
        self.tree.release_nodes(slot.prefix_nodes)
        self.tree.unpin(pid)
        return slot.request


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
