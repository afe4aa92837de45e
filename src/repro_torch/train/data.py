"""Deterministic, resumable token pipeline (a copy of the reference's
``repro/train/data.py``: pure numpy, bit-identical batches).

Production shape without production data: batches are generated from a
counter-based hash (stateless — ``batch_at(step)`` is pure), so

* any host can produce exactly its shard of any step (multi-host friendly,
  no data server in the loop),
* resume-after-crash needs only the step counter from the checkpoint
  manifest (no iterator state files),
* two runs with the same seed see bit-identical data regardless of
  restarts, host count, or prefetch depth.

Documents are variable-length (zipf-ish) and packed into fixed ``seq_len``
rows with cross-document attention breaks marked by a separator token —
the same packing discipline a real corpus pipeline needs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SEP = 0  # document separator / padding id


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512


class TokenPipeline:
    """Counter-based deterministic batches of packed documents."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        # one RNG stream per (step, row): cheap, order-independent
        rng = np.random.default_rng(
            np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(step) * np.uint64(1_000_003)
            + np.uint64(row)
        )
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        pos = 0
        while pos < out.size:
            doc_len = int(rng.exponential(cfg.mean_doc_len)) + 8
            take = min(doc_len, out.size - pos)
            # zipf-distributed ids: natural-language-like unigram skew, so
            # the loss has learnable structure (uniform ids would start AT
            # the optimum ln V)
            ids = rng.zipf(1.3, size=take)
            out[pos : pos + take] = (ids % (cfg.vocab_size - 1) + 1).astype(
                np.int32
            )
            pos += take
            if pos < out.size:
                out[pos] = SEP
                pos += 1
        return out

    def batch_at(
        self, step: int, *, host_id: int = 0, num_hosts: int = 1
    ) -> dict[str, np.ndarray]:
        """The [local_batch, seq_len+1] token block for ``step`` on this host.

        Rows are striped across hosts so the global batch is the
        concatenation of per-host shards in host order.
        """
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0, (cfg.global_batch, num_hosts)
        local = cfg.global_batch // num_hosts
        rows = [self._row(step, host_id * local + r) for r in range(local)]
        return {"tokens": np.stack(rows)}

    def batches(self, start_step: int = 0, *, host_id: int = 0, num_hosts: int = 1):
        step = start_step
        while True:
            yield step, self.batch_at(step, host_id=host_id, num_hosts=num_hosts)
            step += 1
