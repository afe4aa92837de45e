"""MORI on attention-free state: the port's engine for SSM programs (mamba2).

The counterpart of ``repro/serving/ssm_engine.py``. For SSM programs the
per-program serving state is an O(1)-in-sequence-length bundle — SSD state
[L,1,H,P,N] f32 + conv state [L,1,W-1,C] bf16 — not a paged KV cache. Two
structural consequences, both visible here:

* **no radix sharing**: SSM state is a lossy running summary, so the only
  reuse is *exact continuation* — a new request whose tokens extend the
  program's recorded context resumes from the saved state and feeds just
  the suffix (the SSM analogue of chunked prefill over a radix prefix);
* **bundle-granular tiering**: offload/reload moves the whole fixed-size
  bundle (its tensors copied to host memory and back); the two-tier store
  is a counted slot pool, not a page pool.

:class:`SsmEngine` exposes the same surface as
:class:`repro_torch.serving.engine.Engine` (offload/reload/discard/set_label
program verbs), so :class:`~repro_torch.serving.router.MoriRouter` drives it
unchanged, its transfer plane through ``_AtomicStream``. Prefill is the
model's sequence mode (the SSD scan kernel on the card), run eagerly at
each exact length as the reference jits it, with no bucket. Continuation
and generation run the model's one-token decode as one graph per engine
(:class:`repro_torch.serving.graphs.StepGraphs`, batch 1), the
counterpart of the reference's ``jax.jit(model.decode)``: it updates a
static state in place (``Model.decode_into``). A request copies its
bundle's state in, replays the graph once per token it feeds, and leaves
a copy of the state in its bundle, so bundles never alias the static
state and tier moves see the same tensors as before. On the CPU the same
step runs eagerly.
``bundle_bytes`` counts every cache leaf at 2 bytes, as the reference does,
although the ``ssm`` leaf is f32: the router's capacity accounting then
plans the same moves as the reference's. The engine runs on the GPU unless
the caller asks for the CPU (``device="cpu"``); with no CUDA device it
raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis import compile_tracker
from repro_torch.core.types import Tier, TypeLabel
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import leaves
from repro_torch.serving.engine import (
    _ENGINE_IDS,
    Completion,
    EngineRequest,
    _to_device,
    resolve_device,
)
from repro_torch.serving.graphs import StepGraphs


@dataclass
class _Bundle:
    cache: dict                        # {"ssm": [L,1,...], "conv": [L,1,...]}
    ctx: list[int]                     # tokens summarized by the state
    label: TypeLabel = TypeLabel.BUSY
    last_used: int = 0


class _PoolShim:
    """Capacity view the router reads (page == one state bundle)."""

    def __init__(self, bundle_bytes: int, n_device: int, n_host: int):
        self.page_bytes = bundle_bytes
        self.n_device_pages = n_device
        self.n_host_pages = n_host


class SsmEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        device=None,
        max_slots: int = 4,
        max_seq: int = 512,
        n_device_states: int = 4,
        n_host_states: int = 8,
    ):
        if cfg.family != "ssm":
            raise ValueError(f"SsmEngine serves the ssm family, not {cfg.family}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the model holds ``params`` without copying them when they are
        # already on the device, so engines share one set of weights
        self.model = Model(cfg, {k: _to_device(v, self.device) for k, v in params.items()})
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.n_device_states = n_device_states
        self.n_host_states = n_host_states
        self.device_states: dict[str, _Bundle] = {}
        self.host: dict[str, _Bundle] = {}
        self.labels: dict[str, TypeLabel] = {}
        self._clock = 0
        self._completions: list[Completion] = []
        self.evicted_pages = {"gpu": 0, "cpu": 0}
        self.steps = 0

        self.bundle_bytes = sum(
            int(np.prod(l.shape)) * 2 for _, l in leaves(self.model.describe_cache(1, 1))
        )
        self.pool = _PoolShim(self.bundle_bytes, n_device_states, n_host_states)
        # compile plane: the one decode graph over a static state and token
        self._audit_id = next(_ENGINE_IDS)
        self.graphs = StepGraphs(f"engine{self._audit_id}.ssm_decode", self.device)
        self._state: dict[str, torch.Tensor] = {}
        self._token = torch.zeros(1, dtype=torch.long, device=self.device)
        if compile_tracker.enabled():
            tracker = compile_tracker.get_tracker()
            for name, cache in self.graph_functions().items():
                tracker.register(name, cache)

    # ------------------------------------------------------- compile plane
    def graph_functions(self) -> dict:
        """The hot-path graph caches by tracker name."""
        return {f"engine{self._audit_id}.ssm_decode_graphs": self.graphs}

    def warmup(self) -> None:
        """Capture the decode graph before traffic (on the static state,
        which the first request overwrites); with the compile tracker
        armed, its size becomes this engine's capture budget."""
        tracker = compile_tracker.get_tracker()
        with tracker.phase("warmup"):
            self._decode_state()
        if compile_tracker.enabled():
            tracker.mark_warm(tuple(self.graph_functions()))

    def _decode_state(self) -> dict:
        """The static decode state, its decode graph captured on first
        use (before any bundle is copied in: the capture's eager run on
        the card advances the state it runs on)."""
        if "decode" not in self.graphs:
            if not self._state:
                self._state = {
                    name: torch.zeros(leaf.shape, dtype=leaf.dtype, device=self.device)
                    for name, leaf in leaves(self.model.describe_cache(1, 1))
                }
            model, state, token = self.model, self._state, self._token
            self.graphs.capture("decode", lambda: model.decode_into(state, token)[0])
        return self._state

    # ------------------------------------------------------------ surface
    def free_slot_count(self) -> int:
        """Execution is synchronous inside :meth:`submit`, so a slot is
        always free — the router's pump probe sees the full budget."""
        return self.max_slots

    def _load_state(self, cache: dict) -> None:
        """Copy a bundle's state into the static decode state."""
        for name, t in self._decode_state().items():
            t.copy_(cache[name])

    def _step_tokens(self, token: int):
        """Feed one token through the decode graph: returns its logits
        [V], valid until the next step."""
        self._token.fill_(token)
        return self.graphs.replay("decode")

    @torch.no_grad()
    def submit(self, req: EngineRequest) -> int:
        self._clock += 1
        pid = req.program_id
        tokens = req.tokens
        reloaded = 0

        bundle = self.device_states.get(pid)
        if bundle is None and pid in self.host:
            bundle = self._reload(pid)
            reloaded = 1

        if (
            bundle is not None
            and len(tokens) > len(bundle.ctx)
            and tokens[: len(bundle.ctx)] == bundle.ctx
        ):
            # exact continuation: resume from the state, feed the suffix
            # (a non-extending request can't reuse — the state has already
            # consumed its last token and SSM state can't roll back)
            cached = len(bundle.ctx)
            cache = bundle.cache
            suffix = tokens[cached:]
        else:
            # divergence or no state: recompute from scratch
            if bundle is not None:
                self._drop(pid)
            cached = 0
            cache = None
            suffix = tokens

        ctx = list(tokens)
        loaded = False
        if cache is None:
            batch = {"tokens": torch.tensor([tokens], dtype=torch.long, device=self.device)}
            logits, cache = self.model.prefill(batch)
            last_logits = logits[0]
            prefilled = len(tokens)
        else:
            prefilled = len(suffix)
            self._load_state(cache)
            loaded = True
            for tok in suffix:
                last_logits = self._step_tokens(tok)

        out: list[int] = []
        for i in range(req.max_new_tokens):
            nxt = int(torch.argmax(last_logits))
            out.append(nxt)
            if i == req.max_new_tokens - 1:
                break                  # don't feed the final token: the
                # stored state then summarizes exactly ``ctx`` and the next
                # (strictly extending) request starts from a clean suffix
            ctx.append(nxt)
            if not loaded:
                self._load_state(cache)
                loaded = True
            last_logits = self._step_tokens(nxt)
        if loaded:
            cache = {name: t.clone() for name, t in self._state.items()}

        self.device_states[pid] = _Bundle(
            cache, ctx, self.labels.get(pid, TypeLabel.BUSY), self._clock
        )
        self._enforce_device_capacity()
        self.steps += 1
        self._completions.append(
            Completion(
                program_id=pid,
                output_tokens=out,
                cached_tokens=cached,
                prefilled_tokens=prefilled,
                reloaded_pages=reloaded,
            )
        )
        return self.steps

    def step(self, active: "list[int] | None" = None) -> list[Completion]:
        """Drain completions. ``active`` is accepted for pump-API parity and
        ignored — :meth:`submit` already ran the whole request, so every
        stashed completion is final regardless of pacing."""
        del active
        done, self._completions = self._completions, []
        return done

    def run_to_completion(self, max_steps: int = 10_000) -> list[Completion]:
        return self.step()

    # --------------------------------------------------------- tier moves
    def offload_program(self, pid: str) -> int:
        bundle = self.device_states.pop(pid, None)
        if bundle is None:
            return 0
        if len(self.host) >= self.n_host_states:
            self._evict_host()
        self._to_host(bundle)
        self.host[pid] = bundle
        return 1

    def reload_program(self, pid: str) -> int:
        return 1 if self._reload(pid) is not None else 0

    def discard_program(self, pid: str, tier: Tier) -> None:
        if tier is Tier.GPU:
            self.device_states.pop(pid, None)
        else:
            self.host.pop(pid, None)

    def set_label(self, pid: str, label: TypeLabel) -> None:
        self.labels[pid] = label
        for store in (self.device_states, self.host):
            if pid in store:
                store[pid].label = label

    # ----------------------------------------------------------- internals
    @staticmethod
    def _to_host(bundle: _Bundle) -> None:
        bundle.cache = {k: t.to("cpu") for k, t in bundle.cache.items()}

    def _reload(self, pid: str) -> _Bundle | None:
        bundle = self.host.pop(pid, None)
        if bundle is None:
            return None
        bundle.cache = {k: t.to(self.device) for k, t in bundle.cache.items()}
        self.device_states[pid] = bundle
        self._enforce_device_capacity(keep=pid)
        return bundle

    def _drop(self, pid: str) -> None:
        self.device_states.pop(pid, None)
        self.host.pop(pid, None)

    def _enforce_device_capacity(self, keep: str | None = None) -> None:
        """Typed eviction, GPU order: inactive -> idle -> busy, LRU within."""
        order = {TypeLabel.INACTIVE: 0, TypeLabel.IDLE: 1, TypeLabel.BUSY: 2}
        while len(self.device_states) > self.n_device_states:
            victims = sorted(
                (p for p in self.device_states if p != keep),
                key=lambda p: (order[self.device_states[p].label],
                               self.device_states[p].last_used),
            )
            if not victims:
                break
            v = victims[0]
            self.evicted_pages["gpu"] += 1
            b = self.device_states.pop(v)
            if len(self.host) < self.n_host_states:
                self._to_host(b)
                self.host[v] = b

    def _evict_host(self) -> None:
        """Typed eviction, host order: inactive -> busy -> idle (reversed —
        the host tier preferentially retains idle programs, paper §4.3.2)."""
        order = {TypeLabel.INACTIVE: 0, TypeLabel.BUSY: 1, TypeLabel.IDLE: 2}
        if not self.host:
            return
        v = min(self.host, key=lambda p: (order[self.host[p].label],
                                          self.host[p].last_used))
        self.host.pop(v)
        self.evicted_pages["cpu"] += 1
