"""Serving control-plane persistence (restart / failover).

What must survive a router crash is the *control plane*: the program table
(tier, replica, context length, idleness window), per-replica tier usage,
and — since the decode-pump router — the per-slot batch occupancy at
snapshot time. KV pages themselves are NOT persisted — on restart a
program whose pages died with the engine re-enters through the Waiting
queue and recomputes, which is exactly MORI's §4.3.1 semantics (the
recompute path doubles as the recovery path).

:func:`control_plane_state` is the single source of truth for the
snapshot schema; ``repro_torch.serving.router.snapshot_state`` delegates here
(the two used to serialize overlapping state independently).

Snapshots are atomic (write-temp + os.replace) and versioned; ``restore``
rebuilds scheduler state onto a (possibly different-sized) replica set —
programs homed on replicas that no longer exist are re-queued as Waiting.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

from repro_torch.core.types import Tier, TypeLabel

#: v2 adds the per-replica section (tier byte usage + live decode-slot
#: occupancy); v3 adds tier formats (per-replica pool device/offload
#: formats and per-program wire_bytes_per_token) so restored placement
#: decisions keep pricing transfers at the format actually moved. v1/v2
#: snapshots (no format fields) still restore — absent fields mean bf16
#: everywhere, which is exactly what those versions could express.
FORMAT_VERSION = 3


def control_plane_state(router) -> dict:
    """The serializable control-plane view of a router: program table,
    per-replica tier usage, and live decode-slot occupancy."""
    sched = router.sched
    replicas = []
    for rep in sched.replicas:
        r = rep.replica_id
        pump = router._pump_slots[r] if r < len(router._pump_slots) else {}
        pool = getattr(router.engines[r], "pool", None) if r < len(
            router.engines
        ) else None
        replicas.append(
            {
                "gpu_used": rep.gpu_used,
                "cpu_used": rep.cpu_used,
                "ssd_used": rep.ssd_used,
                "device_format": getattr(pool, "device_format", "bf16"),
                "offload_format": getattr(pool, "offload_format", "bf16"),
                "slots": [
                    {
                        "pid": s.pid,
                        "step_idx": s.step_idx,
                        "decode_steps_taken": s.steps_taken,
                        "started_at": s.start,
                        "window_end": s.end,
                    }
                    for s in sorted(pump.values(), key=lambda s: s.seq)
                ],
            }
        )
    return {
        "version": FORMAT_VERSION,
        "num_replicas": len(sched.replicas),
        "programs": {
            pid: {
                "tier": p.tier.value,
                "replica": p.replica,
                "context_tokens": p.context_tokens,
                "kv_bytes_per_token": p.kv_bytes_per_token,
                "wire_bytes_per_token": p.wire_bytes_per_token,
                "label": p.label.value,
                "steps_completed": p.steps_completed,
                "finished": p.finished,
                "window": p.tracker.window_dump(),
            }
            for pid, p in sched.programs.items()
        },
        "replicas": replicas,
    }


def requeue_resident_slots(router, replica: int, now: float) -> int:
    """Tear down a failed replica's mid-flight decode/prefill slots and
    return their requests to the router's pending queue — the live-drain
    counterpart of :func:`restore_snapshot`'s was-resident handling.

    Each slot's engine-side state is released (``cancel_prefill`` for a
    slot still mid-prefill, ``Engine.abort_request`` for a decoding one;
    a slot whose decode already finished engine-side holds no pages and
    needs no teardown) and its ``(request, step_idx)`` goes back to
    ``router._pending``. The requeued step re-prefills the *identical*
    token context on whichever healthy replica the scheduler re-places it
    — decode is deterministic in the context, so the program's token
    stream is byte-identical to an undisturbed run: zero tokens lost.

    Returns the number of slots requeued.
    """
    slots = router._pump_slots[replica]
    eng = router.engines[replica]
    n = 0
    for slot in sorted(slots.values(), key=lambda s: s.seq):
        if slot.prefilling:
            eng.cancel_prefill(slot.prefill)
        elif slot.done is None and hasattr(eng, "abort_request"):
            eng.abort_request(slot.pid)
        router._pending[slot.pid] = (slot.req, slot.step_idx)
        # restart the TTFT clock only if the first token never landed
        # (the re-run's latency is what a caller would actually see)
        router._ttft_start.setdefault(
            (slot.pid, slot.step_idx), time.perf_counter()
        )
        n += 1
    slots.clear()
    return n


def save_snapshot(router, path: str | os.PathLike) -> Path:
    """Atomic JSON snapshot of the router's control-plane state."""
    snap = control_plane_state(router)
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(snap, indent=1))
    os.replace(tmp, path)
    return path


def restore_snapshot(router, path: str | os.PathLike) -> dict:
    """Rebuild scheduler state from a snapshot onto ``router``.

    KV residency is conservative: every restored unfinished program enters
    the Waiting tier (its pages died with the old process); its context
    length and idleness window survive, so placement decisions pick up
    where they left off after the first recompute. Programs homed on
    replicas beyond the new replica count are likewise Waiting, and
    programs that were resident in decode slots at snapshot time (their
    step was mid-flight) are counted separately — their in-flight step is
    simply re-issued after recompute, like a replica failure.

    Returns counters {"restored": n, "requeued": m, "was_resident": k}.
    """
    snap = json.loads(Path(path).read_text())
    assert snap["version"] in (1, 2, FORMAT_VERSION), snap["version"]
    sched = router.sched
    resident = {
        s["pid"]
        for rep in snap.get("replicas", [])
        for s in rep.get("slots", [])
    }
    restored = requeued = was_resident = 0
    for pid, rec in snap["programs"].items():
        if rec["finished"]:
            continue
        prog = sched.program_arrived(
            pid, rec["kv_bytes_per_token"], 0.0,
            wire_bytes_per_token=rec.get("wire_bytes_per_token"),
        )
        prog.context_tokens = rec["context_tokens"]
        prog.steps_completed = rec["steps_completed"]
        prog.label = TypeLabel(rec["label"])
        prog.tracker.window_load(rec["window"])
        # conservative placement: pages did not survive the crash
        prog.tier = Tier.NONE
        prog.replica = None
        restored += 1
        requeued += 1
        if pid in resident:
            was_resident += 1
    return {
        "restored": restored,
        "requeued": requeued,
        "was_resident": was_resident,
    }
