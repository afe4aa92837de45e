"""What ``tests/test_torch_tp.py``'s two sides share: the engine and router
settings, the contexts, the corpus and the kernel cases. Plain Python and
numpy: the reference's subprocess (``_tp_reference.py``) and the port's
ranks (``_tp_ranks.py``) each build their own objects from these."""
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
