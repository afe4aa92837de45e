#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that the
port starts on the GPU and that its main paths run through its kernels.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1-2, 9's kernel cases and 10, no final line
                                          # (and not phase 11)

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and
``nvcc``; it builds every kernel from the sources in ``src/repro_torch``
first, one ``nvcc`` per source, all started together. Phases, each fatal
on failure (a failure exits non-zero and prints no final line):

1. the card's name and power limit; build the paged-attention, flash
   attention (forward and backward) and SSD (forward and backward)
   kernels and print the
   compiler's register and shared-memory summary;
2. each kernel against its plain PyTorch version on the card, at the
   reference's test shapes and at the serving paths' shapes: paged
   attention (bf16/f32/int8 pages, MHA/GQA/MQA, softcap, windows, zamba2's
   D = 160, gemma2's 4096-slot ring and 4624-slot global and full-size
   local caches read as pages, in f32 and bf16; 30-token pages, and
   whisper's 1500-position cross cache read as such pages), flash
   attention (the reference's shapes and variants, ragged lengths,
   q_offset chunks, kv_hole, kv_lengths, GQA, MQA, D=128, both layouts,
   gemma2's 4600-token local layer with window 4096 and softcap 50,
   whisper's 1500-position bidirectional encoder and its cross-attention
   from a 64-token prompt, internvl2's 856-token prefill at 48/8 heads of
   128) and the SSD scan (the
   reference's shapes and a ragged S on the CUDA-core
   route; the full-width shape at S = 1, 128, 200, 256 and 1024, two rows,
   chunks of 64 and 256 and strided slices of one fused tensor on the
   tensor-core route, also against the passes' plain version; the
   sequential scan at a tiny shape; zamba2's N = 64); then each kernel's,
   its plain
   version's and, where one PyTorch call computes the same function, that
   call's time at the serving path's shape, beside the least time the card
   could take for the same work; each kernel's own device time per call
   (``device_ms``, all its passes) from ``torch.profiler``, for the SSD
   scan at S = 128, 200, 256 and 2048 and for its CUDA-core route at 256;
   the paged kernel also at zamba2's decode shape (D = 160) and at
   whisper's cross-attention decode (30-token pages), flash at gemma2's
   local layer and phase 8's whisper and internvl2 shapes, the SSD scan
   at zamba2's N = 64. gemma2's cases
   scale q so its logits reach the softcap, and each shows that its band
   rejects the plain version without the softcap or the window;
3. the models on a small input, card (kernels) against CPU (plain
   versions): reduced qwen prefill, chunked prefill over a bucketed
   prefix and paged decode; reduced mamba2 prefill and decode;
4. the qwen main path: ``qwen1.5-0.5b`` at full width with random weights
   from a seed, served by two engines behind ``MoriRouter.replay`` with the
   launcher's defaults (monolithic prefill), then again with chunked
   prefill, each engine warmed first (``Engine.warmup``: one CUDA graph of
   the decode step per table bucket) with the compile tracker armed, each
   replay run under ``torch.profiler``; no graph may be captured during a
   replay, every decode step must be one replay, no paged wrapper may be
   called (a replay calls none), the paged kernels the device ran (the
   kernel's own count on the device, one a launch; the profiler's count
   of ``paged_split_kernel`` instances beside it) must equal layers x
   decode steps, the flash kernel's launches layers x
   prefill passes, and pages must move between the tiers; then each table
   bucket's graph (bf16, and one on an int8 pool) against the same step
   run eagerly on a clone of the pool, bit for bit, each replay running
   one paged kernel a layer; then where a full-width decode step's time
   goes, graphed and eager;
5. the SSM main path: ``mamba2-2.7b`` at full width with random weights
   from a seed, served by a warmed ``SsmEngine`` behind
   ``MoriRouter.replay``; the SSD kernel's launches must equal layers x
   sequence prefills, every decode token must be one replay of the decode
   graph, and state bundles must go to the host and come back; then the
   decode graph against the eager step, bit for bit, and where a
   full-width prefill's and decode step's time goes, graphed and eager;
6. the MoE main path: ``dbrx-132b`` at full width (48/8 heads of 128, 16
   experts top-4 of width 10,752, vocab 100,352, capacity factor 1.25)
   cut from 40 layers to 4, random weights drawn on the card from a seed,
   served like the qwen replay (two warmed engines, the launcher's pools,
   corpus and scheduler, monolithic prefill) under ``torch.profiler``, with
   the same checks; one full-width MoE layer in bf16 against the same
   function in f32 on the card (decode and a 384-token prefill: chosen
   experts and kept slots equal, the output in the model band); every
   table bucket's dbrx decode graph against its eager step, bit for bit;
   and where a decode step's time goes, the MoE products against the
   bytes of expert weights they must read;
7. the reference's other serving modes, at qwen's full width on phase
   4's weights, launcher pools and corpus, without the profiler (the
   kernels count their own device launches): the dense-slot decode
   attention (the slot cache read as pages by the paged kernel) against
   its plain version; ``serve_dense_slots``, two warmed
   ``Engine(dense_slots=True)`` replicas (one decode graph each,
   captured in warmup and replayed at every step, paged kernels = layers
   x decode steps, flash = layers x prefill passes), whose output log
   must equal phase 4's or part from it only at near ties; and
   ``serve_replicas``, two warmed paged replicas with pressure migration,
   int8 offload, an NVMe tier and the page-lifetime sanitizer, replica 1
   failing mid-replay and recovering: programs migrate, one drain, every
   program completes every step, offloads billed at the int8 page size,
   no capture after warmup, paged kernels = layers x decode steps;
8. the families the reference runs only at model level, at full
   width and depth on weights drawn on the card, eagerly: ``gemma2-9b``
   (prompts of 4600 and 1000 tokens prefilled one at a time, flash =
   layers x prefills; 16 greedy steps over a local ring of 4096 slots
   that the longer prompt wraps and again over full-size local slots,
   paged kernels on the device = layers x steps in each run, tokens
   equal or parted at a near tie; the last step against a prefill of the
   longer sequence) and ``zamba2-2.7b`` (prompts of 384 and 200 tokens:
   SSD = mamba layers x prefills, all on the tensor cores, flash = groups
   x prefills; 16 greedy steps, paged kernels at D = 160 = groups x
   steps; the last step against a prefill of the longer sequence),
   ``whisper-medium`` (frames of 1500 x 1024 a row and prompts of 64 and
   24 tokens: flash = (encoder + 2 x decoder layers) x prefills; 16
   greedy steps at batch 2, paged kernels = 2 x decoder layers x steps,
   the cross cache read as 30-token pages; the cross and self cache
   bytes; the last step against a prefill of the longer sequence) and
   ``internvl2-26b`` (256 image embeddings before prompts of 600 and 200
   tokens: flash = layers x prefills; 16 greedy steps over slots, then
   the same tokens through ``decode_paged`` over a pool, paged kernels =
   layers x steps in each, tokens equal or parted at a near tie; the
   last step against a prefill of the longer sequence);
9. training: the flash backward kernel against its plain version
   (autograd through ``blockwise_attention`` in f32) at qwen's training
   shape, a gemma2-like GQA layer with window and softcap at D = 256,
   D = 160, whisper's cross-attention and ragged 1000-row tails at
   32/8 x 128, in f32 and bf16, each on the route it must take (bf16 at
   D <= 128 on the tensor cores), each band shown to reject the gradient
   without the softcap or window or under the other mask; its time on
   both routes beside its bound and SDPA's backward; reduced
   qwen's ``Model.loss`` and every gradient on the card against the CPU;
   ``qwen1.5-0.5b`` at full width trained for 6 steps through the
   launcher's code path (seed-0 weights drawn on the card, 2
   microbatches of 4 x 1024 tokens, remat): every loss finite, the last
   below the first, the flash forward launched 2 x layers x microbatches
   x steps times and its backward layers x microbatches x steps, every
   backward on the tensor cores, peak
   memory, one step's host-clock and device time; a checkpoint saved and
   restored onto the card; the SSD backward kernel against its plain
   version (autograd through ``ssd_reference`` in f32) at the reference's
   shapes, mamba2's training shape (bf16 slices of one fused tensor), a
   ragged S = 1000, one chunk and zamba2's N = 64, in f32 and bf16, with
   and without a final-state cotangent, each on the backward route it
   must take (the tensor cores for bf16 at mamba2's and zamba2's widths,
   the CUDA cores for f32 and the reference's widths), each band shown to
   reject the passes' plain version without the reverse state pass, the
   carried state, the decay's gradient or the causal mask, two calls
   equal bit for bit on either route; at mamba2's shape with dt as random
   full-width weights give it, where autograd through ``ssd_reference``
   turns NaN, held to the passes' plain version and finite; its time on
   both routes, pass by pass, beside its bound; reduced mamba2's and
   zamba2's loss and gradients on
   the card against the CPU; then
   ``mamba2-2.7b`` and ``zamba2-2.7b`` at full width and depth trained
   for 3 steps through the launcher (seed-0 weights drawn on the card, 2
   microbatches of 2 x 1024 tokens, lr 1e-4, remat): losses finite and
   the last below the first, the
   SSD forward launched 2 x mamba layers x microbatches x steps times and
   its backward mamba layers x microbatches x steps, every one on the
   tensor cores (zamba2's shared block: flash likewise per group,
   backwards on the CUDA cores), peak
   memory, one step's host-clock and device time and the SSD backward's
   share;
10. the library yardstick of gemma2's local layer, compiled
   ``flex_attention`` with its softcap and window (SDPA has no softcap),
   held to the kernel's output and timed; after the profiled phases,
   because after ``torch.compile`` a profile can lose kernel records;
11. the audit plane on the card: the step auditor's seeded selftest
   (``repro_torch.analysis.jitaudit``); the audit of full-width qwen
   engines on phase 4's weights with the launcher's pools (every paged
   decode bucket, every chunk-prefill spec, the dense-slot spec) and of
   the three kernels' targets: no violation, and each captured bucket's
   replay timed against its static bound (roofline share in (0, 1.05]);
   the replay gate (a warmed engine behind the router's chunked pump
   captures nothing after warmup); the account: every timing line's
   bytes, operations and bound equal what the kernels' ``cost`` gives at
   its shapes (the bounds PERF.md records among them); and the port's
   lint over its default paths, clean. One ``jitaudit`` line holds it.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the per-kernel JSON record and the card's name and power limit. The
``graph parity`` line holds each graph's largest logit difference from
the eager step (qwen, mamba2 and dbrx).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the card's peaks and the bound of a kernel call from its ``cost`` (one
#: account: the auditor sums the same costs over a step)
from repro_torch.kernels.roofline import PEAK_OPS_PER_S, bound, bound_of  # noqa: E402

#: kernel-vs-plain bands, the reference's own (tests/test_kernels.py tol()
#: and tests/test_kv_quant.py EXACT_BAND): both sides compute in f32 from
#: identical operands, so what differs is summation order plus, for a bf16
#: output, one rounding of the result
ATOL = {"float32": 2e-3, "bfloat16": 2e-2}
#: the SSD final state's band (tests/test_kernels.py:234)
STATE_ATOL = 1e-2
#: model logits and pages, card (kernels) against CPU (plain versions),
#: bf16 weights: the band of tests/test_torch_model.py, one bf16 ulp at the
#: residual stream's magnitude (2**-4) plus 2**-6 relative; the backends
#: sum bf16 matmuls in different orders
MODEL_ATOL, MODEL_RTOL = 2**-4, 2**-6

PAGED_SHAPES = [
    # B, H, KH, D, page_tokens, pages_per_seq
    (1, 4, 4, 64, 8, 2),      # MHA
    (3, 8, 2, 64, 8, 4),      # GQA 4:1
    (2, 16, 8, 128, 16, 3),   # GQA 2:1, 128-dim
    (4, 4, 1, 64, 16, 5),     # MQA
]
#: the serving path's shape at full width: 3 slots, MHA 16x64, 16-token
#: pages, 24 pages = max_seq 384, ragged lengths
MAIN_SHAPE = (3, 16, 16, 64, 16, 24)
MAIN_LENGTHS = [384, 250, 97]
#: zamba2-2.7b's shared-block decode at full width (phase 8): 2 rows, MHA
#: 32 heads of 2·2560/32 = 160, 16-token pages, max_seq 400 = 25 pages, at
#: the phase's prompt lengths; one cache a group, 9 groups
D160_SHAPE = (2, 32, 32, 160, 16, 25)
D160_LENGTHS = [384, 200]
D160_LAYERS = 9
#: gemma2-9b's decode attention at full width (phase 8): 2 rows, 16 query
#: heads over 8 KV heads of 256, softcap 50; a local ring of 4096 slots,
#: global slots of 4624, the lengths the 16th step reaches, the window of
#: a full-size local cache. q is scaled by 8: with unit k the scores have
#: std 8 and their largest reach ~30, where cap·tanh(s/cap) bends them
GEMMA2_DECODE = dict(B=2, H=16, KH=8, D=256, ring=4096, slots=4624, lengths=[4616, 1016],
                     window=4096, cap=50.0, q_scale=8.0)
FLASH_SHAPES = [
    # B, H, KH, S, D (tests/test_kernels.py)
    (2, 4, 4, 64, 32),
    (1, 8, 2, 128, 64),
    (2, 4, 1, 64, 64),
]
FLASH_VARIANTS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=24),
    "bidir": dict(causal=False),
    "softcap": dict(causal=True, softcap=50.0),
}
#: qwen1.5-0.5b's prefill attention at full width (bf16, H = KH = 16,
#: D = 64): monolithic at max_seq, and one 64-token chunk over a prefix of
#: 100 real tokens padded to 8 pages of 16 (the 4-page table bucket)
FLASH_MAIN = dict(B=1, H=16, KH=16, D=64, S=384)
FLASH_CHUNK = dict(B=1, H=16, KH=16, D=64, Sq=64, Sp=128, prefix_valid=100)
#: a long causal prefill at qwen's widths (whisper's encoder holds 1500
#: frames): timed only, to show where the kernel stands beyond the serving
#: path's shape
FLASH_LONG_S = 1536
#: prefill attention at the other full-width shapes timed beside qwen's:
#: dbrx-132b's (GQA 6:1, D = 128), zamba2's shared attention block (32
#: heads of 2·2560/32 = 160) and gemma2-9b's (16 heads over 8 KV heads of
#: 256), each over a prompt of max_seq = 384 tokens
FLASH_OTHER = {
    "dbrx": dict(B=1, H=48, KH=8, D=128, S=384),
    "d160": dict(B=1, H=32, KH=32, D=160, S=384),
    "d256": dict(B=1, H=16, KH=8, D=256, S=384),
}
#: gemma2-9b's local-layer prefill in phase 8: the 4600-token prompt, a
#: 4096-token window and softcap 50 (SDPA has no softcap: the library
#: time is compiled ``flex_attention``'s, phase 10); q scaled as in
#: GEMMA2_DECODE
FLASH_GEMMA2 = dict(B=1, H=16, KH=8, D=256, S=4600, window=4096, cap=50.0, q_scale=8.0)
#: prefill attention of phase 8's whisper-medium and internvl2-26b at full
#: width: whisper's encoder layer (1500 positions, bidirectional, 16x64),
#: its cross-attention over them from the 64-token prompt (not causal), and
#: internvl2's prefill of 256 image tokens and a 600-token prompt (48 query
#: heads over 8 KV heads of 128, causal). SDPA computes each without a mask
#: tensor (no mask where every key is visible, ``is_causal`` for a prompt
#: from position 0)
FLASH_MODELS = {
    "whisper_encoder": dict(B=1, Sq=1500, Skv=1500, H=16, KH=16, D=64, causal=False),
    "whisper_cross": dict(B=1, Sq=64, Skv=1500, H=16, KH=16, D=64, causal=False),
    "internvl2": dict(B=1, Sq=856, Skv=856, H=48, KH=8, D=128, causal=True),
}
#: key rows a kv tile of either flash kernel reads
FLASH_KV_TILE = 64
#: whisper-medium's cross-attention decode in phase 8: 2 rows, 16x64 MHA
#: over the 1500 encoder positions, which the card reads as 30-token pages
#: (the largest divisor of 1500 not above 32); 24 decoder layers a step
CROSS_DECODE = dict(B=2, H=16, KH=16, D=64, S=1500, layers=24)
SSD_SHAPES = [
    # b, s, h, p, n, chunk (tests/test_kernels.py)
    (2, 32, 2, 8, 8, 8),
    (1, 64, 4, 16, 16, 16),
    (2, 128, 4, 32, 16, 32),
]
#: mamba2-2.7b's scan at full width: 80 heads of 64, state 128, chunk 128
SSD_MAIN = dict(b=1, h=80, p=64, n=128, chunk=128)
SSD_MAIN_S = 256
#: zamba2-2.7b's scan (phase 8): mamba2's heads with state 64, its longer
#: prompt
SSD_ZAMBA2 = dict(b=1, h=80, p=64, n=64, chunk=128, S=384)
#: a long prefill at mamba2's widths: timed only, to show where the scan
#: stands beyond the serving path's lengths
SSD_LONG_S = 2048
#: the SSD kernels' names: the CUDA-core ``ssd_kernel`` and the tensor-core
#: passes ``ssd_tc_chunk_state_kernel``, ``ssd_tc_state_pass_kernel`` and
#: ``ssd_tc_output_kernel``
SSD_KERNEL_NAMES = ("ssd_kernel", "ssd_tc_")
#: profiles of one timed loop before ``device_ms_per_call`` gives up: late
#: in a run, three profiles in a row have held 3, 8 and 9 of 10 calls' records
PROFILE_ATTEMPTS = 6
#: spin kernels (``torch.cuda._sleep``) before and after a profiled loop,
#: and the name that leaves them out of its times
PROFILE_PADS, PAD_KERNEL = 4, "spin_kernel"
#: cycles of the spin kernel queued ahead of a call timed by
#: ``device_ms_behind_spin`` (~1 ms on an H100), longer than the host
#: takes to enqueue the call
SPIN_CYCLES = 2_000_000
#: the MoE main path: dbrx-132b at full width, cut from 40 layers to 4
#: (14.3 B parameters, 28.5 GB in bf16)
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 4
#: where every phase runs
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_call(fn, reps: int) -> float:
    """Milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def with_f32_ops(cost: dict) -> dict:
    """:func:`bound_of` ``cost``, and its operations' time at the f32 peak
    (what the CUDA-core route could reach at best)."""
    rec = bound_of(cost)
    rec["ops_ms_f32_cuda_cores"] = cost["flops"] / PEAK_OPS_PER_S["float32"] * 1e3
    return rec


def check_close(name: str, got, want, atol: float) -> float:
    """Hold ``got`` to ``want`` within ``atol`` + ``atol``·|want|; log and
    return the largest absolute error, raise outside the band."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = math.isfinite(err) and bool((diff <= atol + atol * want.float().abs()).all())
    log(f"kernel case {name}: max_abs_err {err:.3e} (rtol=atol={atol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version on {name}")
    return err


def check_band_binds(name: str, want, without: dict, atol: float) -> None:
    """Show that ``check_close``'s band on ``name`` can tell: each entry of
    ``without`` (a feature's name -> the plain version computed without
    it, a missing softcap or window) must fall outside the band around
    ``want`` somewhere, as a kernel that dropped the feature would."""
    want = want.float()
    band = atol + atol * want.abs()
    for feature, out in without.items():
        excess = ((out.float() - want).abs() - band).max().item()
        log(f"band check {name}: without {feature} the largest excess over the band is "
            f"{excess:.3e} {'rejected' if excess > 0 else 'ACCEPTED'}")
        if not excess > 0:
            raise AssertionError(f"the band of {name} cannot tell a missing {feature}")


def device_ms_per_call(fn, calls: int, names: tuple | None) -> dict:
    """The device time, per wrapper call, of the kernels whose names hold
    one of ``names`` (every kernel for ``None``), from ``torch.profiler``
    over ``fn`` (which makes ``calls`` wrapper calls). Event timing of a
    loop of Python calls measures the wrapper's host cost once a kernel
    takes a few microseconds; this measures the kernels alone. Each named
    kernel (each pass of a call) must appear ``calls`` times, and for
    ``None`` every kernel a whole multiple of ``calls`` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def pad():
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(1)

    # profiles have come back without some of the kernels' device records
    # (none at all once, half of a loop's once, one or two of a loop's
    # after torch.compile had run) though every launch ran: pad the loop
    # with spin kernels (not counted), profile again a bounded number of
    # times, and say so
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        counts: dict = {}
        with torch.profiler.profile(activities=acts) as prof:
            pad()
            fn()
            pad()
            torch.cuda.synchronize()
        timed = device_kernel_us(prof, counts)
        pads = sum(n for k, n in counts.items() if PAD_KERNEL in k)
        kernels = {k: v for k, v in timed.items() if PAD_KERNEL not in k
                   and (names is None or any(n in k for n in names))}
        whole = all(counts[k] == calls if names is not None else counts[k] % calls == 0
                    for k in kernels)
        if kernels and whole:
            break
        log(f"profile {attempt} of {PROFILE_ATTEMPTS} of {calls} calls held "
            f"{ {k[:40]: counts[k] for k in kernels} } instances of the kernels named {names} "
            f"and {pads} of {2 * PROFILE_PADS} pads")
    else:
        if names is not None or not kernels:
            raise AssertionError(f"no whole profile of the kernels named {names}")
        # a library's profile still short after every attempt (after
        # torch.compile, 32 of 50 flex records three times over): its time
        # is not known, only the instances the profile held
        return dict(device_ms=None, device_kernels_ms=None,
                    profiled_instances={k[:60]: counts[k] for k in kernels},
                    profiled_calls=calls)
    return dict(device_ms=sum(kernels.values()) / calls / 1e3,
                device_kernels_ms={k[:60]: v / calls / 1e3 for k, v in kernels.items()},
                profiled_instances={k[:60]: counts[k] for k in kernels})


def device_ms_by_instance(fn, names: tuple, kinds: int) -> dict:
    """The device time of one call from one ``torch.profiler`` profile of
    ``fn`` (a loop of calls): each of the ``kinds`` kernels named in
    ``names``, which a call launches once each, at its mean over the
    instances the profile held, summed. Profiles lose some records (§7 of
    PERF.md): a long profile late in a run has kept 6 of 10 of each of the
    SSD backward's kernels, three times over, and one has kept none of a
    kernel's. Every instance of a kernel is the same work, so the mean over
    those kept needs none of the lost; a profile that kept no instance of
    one is taken again, a bounded number of times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        counts: dict = {}
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_PADS):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        timed = {k: us / counts[k] for k, us in device_kernel_us(prof, counts).items()
                 if any(n in k for n in names)}
        if len(timed) == kinds:
            break
        log(f"profile {attempt} of {PROFILE_ATTEMPTS} held {len(timed)} of the {kinds} "
            f"kernels named {names}")
    else:
        raise AssertionError(f"no profile held the {kinds} kernels named {names}")
    return dict(device_ms=sum(timed.values()) / 1e3,
                device_kernels_ms={k[:60]: v / 1e3 for k, v in timed.items()},
                profiled_instances={k[:60]: counts[k] for k in timed})


def device_ms_behind_spin(fn, reps: int) -> float:
    """The device time of one call of ``fn`` from CUDA events around it,
    with a spin kernel queued first: the host enqueues the call's kernels
    while the device spins, so the events bracket the device's work (and
    its gaps between the call's kernels), not the host's launch cost. The
    profiler drops some records of a library's kernels (PERF.md §7); this
    needs none. The median of ``reps`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ------------------------------------------------------------ phase 1
def build_kernels():
    """Build every kernel, one nvcc per source, all started together."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    kernels = {"paged_attention": paged_ops.KERNEL, "flash_attention": flash_ops.KERNEL,
               "flash_attention_bwd": flash_ops.KERNEL.backward_kernel, "ssd": ssd_ops.KERNEL,
               "ssd_bwd": ssd_ops.KERNEL.backward_kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(k.load) for k in kernels.values()]:
            fut.result()
    log(f"built {', '.join(kernels)} in {time.perf_counter() - t0:.1f}s; ptxas:")
    for name, k in kernels.items():
        for line in k.build_log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"  {name}: " + line.strip())
    m = SSD_MAIN
    flash = flash_ops.KERNEL.load()
    bwd = flash_ops.KERNEL.backward_kernel.load()
    ssd_smem = ssd_ops.KERNEL.load().ssd_smem(m["p"], m["n"], m["chunk"])
    ssd_bwd = ssd_ops.KERNEL.backward_kernel.load()
    ssd_bwd_smem = [ssd_bwd.ssd_bwd_smem(m["p"], m["n"], m["chunk"], r) for r in (0, 1)]
    log("dynamic shared memory a block: paged_attention split pass (4 warps, G=1, D=64, "
        f"T=16, bf16) {paged_ops.KERNEL.load().paged_attention_decode_smem(1, 64, 16, 1)} B; "
        f"flash_attention f32 D=64 {flash.flash_attention_smem(64)} B, D=128 "
        f"{flash.flash_attention_smem(128)} B, D=160 {flash.flash_attention_smem(160)} B, "
        f"D=256 {flash.flash_attention_smem(256)} B, bf16 D=64 "
        f"{flash.flash_attention_mma_smem(64)} B, D=128 {flash.flash_attention_mma_smem(128)} B, "
        f"D=160 {flash.flash_attention_mma_smem(160)} B, D=256 "
        f"{flash.flash_attention_mma_smem(256)} B; flash_attention_bwd tensor cores "
        f"dK/dV, dQ: D=64 {bwd.flash_attention_bwd_mma_smem(64, 0)}, "
        f"{bwd.flash_attention_bwd_mma_smem(64, 1)} B, D=128 "
        f"{bwd.flash_attention_bwd_mma_smem(128, 0)}, {bwd.flash_attention_bwd_mma_smem(128, 1)} "
        f"B; CUDA cores D=64 {bwd.flash_attention_bwd_smem(64)} B, D=160 "
        f"{bwd.flash_attention_bwd_smem(160)} B, D=256 {bwd.flash_attention_bwd_smem(256)} B; "
        f"ssd CUDA-core kernel (P={m['p']}, "
        f"N={m['n']}, Q={m['chunk']}) {ssd_smem} B, its backward's largest block: CUDA "
        f"cores {ssd_bwd_smem[0]} B, tensor cores {ssd_bwd_smem[1]} B")


# ------------------------------------------------------------ phase 2: paged
def make_case(rng, shape, dtype, lengths=None, quantized=False,
              with_new=True, layers=1):
    """Inputs for one paged-attention case, from a numpy seed, on the card.
    ``layers`` > 1 stacks independent layer slices, as the pool does."""
    from repro_torch.kernels import kv_quant

    B, H, KH, D, T, P = shape
    N = B * P + 3
    dev = DEVICE

    def randn(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)

    q = randn(B, H, D).to(dtype)
    k_new = randn(B, KH, D).to(dtype) if with_new else None
    v_new = randn(B, KH, D).to(dtype) if with_new else None
    kf = randn(layers, N, T, KH, D)
    vf = randn(layers, N, T, KH, D)
    if quantized:
        k, ks = kv_quant.quantize_pages(kf)
        v, vs = kv_quant.quantize_pages(vf)
    else:
        k, v, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    tables = torch.from_numpy(
        rng.permutation(N)[: B * P].reshape(B, P).astype(np.int32)).to(dev)
    if lengths is None:
        lengths = rng.integers(1, P * T + 1, B)
    lengths = torch.as_tensor(np.asarray(lengths, np.int32)).to(dev)
    return dict(q=q, k_new=k_new, v_new=v_new, k=k, v=v, ks=ks, vs=vs,
                tables=tables, lengths=lengths)


def run_kernel(ops, c, layer=0, **kw):
    ks = c["ks"][layer] if c["ks"] is not None else None
    vs = c["vs"][layer] if c["vs"] is not None else None
    if c["k_new"] is None:
        return ops.paged_attention(c["q"], c["k"][layer], c["v"][layer], c["tables"],
                                   c["lengths"], ks, vs, **kw)
    return ops.paged_attention_decode(c["q"], c["k_new"], c["v_new"], c["k"][layer],
                                      c["v"][layer], c["tables"], c["lengths"], ks, vs, **kw)


def run_plain(ref, c, layer=0, **kw):
    ks = c["ks"][layer] if c["ks"] is not None else None
    vs = c["vs"][layer] if c["vs"] is not None else None
    if c["k_new"] is None:
        return ref.paged_attention_ref(c["q"], c["k"][layer], c["v"][layer], c["tables"],
                                       c["lengths"], ks, vs, **kw)
    return ref.paged_attention_decode_ref(c["q"], c["k_new"], c["v_new"], c["k"][layer],
                                          c["v"][layer], c["tables"], c["lengths"], ks,
                                          vs, **kw)


def check_kernel_cases():
    """Every paged-attention variant, kernel against plain version.
    Returns the largest error at the serving path's shape."""
    from repro_torch.kernels.paged_attention import ops, ref

    rng = np.random.default_rng(0)
    cases = []
    for shape in PAGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_new in (False, True):
                cases.append((f"{shape} {dtype} new={with_new}", shape, dtype,
                              dict(with_new=with_new), {}))
        for quant_new in (False, True):
            cases.append((f"{shape} int8 new={quant_new}", shape, torch.float32,
                          dict(quantized=True, with_new=quant_new), {}))
    for window in (6, 16, 100):
        cases.append((f"{PAGED_SHAPES[1]} window={window}", PAGED_SHAPES[1],
                      torch.bfloat16, dict(with_new=True), dict(window=window)))
        cases.append((f"{PAGED_SHAPES[1]} int8 window={window}", PAGED_SHAPES[1],
                      torch.float32, dict(quantized=True), dict(window=window)))
    cases.append((f"{PAGED_SHAPES[2]} softcap=5", PAGED_SHAPES[2], torch.bfloat16,
                  dict(with_new=True), dict(softcap=5.0)))
    cases.append((f"{PAGED_SHAPES[2]} softcap=5 window=20", PAGED_SHAPES[2],
                  torch.float32, dict(with_new=False), dict(softcap=5.0, window=20)))
    # partial tail pages: every length one past a page boundary or short of it
    cases.append((f"{PAGED_SHAPES[3]} tails", PAGED_SHAPES[3], torch.bfloat16,
                  dict(lengths=[1, 17, 31, 80]), {}))
    for quantized in (False, True):
        cases.append((f"main {MAIN_SHAPE} int8={quantized}", MAIN_SHAPE,
                      torch.bfloat16,
                      dict(lengths=MAIN_LENGTHS, quantized=quantized), {}))
    # the split-K plan at work: lengths at the 64-key split boundaries of the
    # serving shape's table, and tables wider than any row (empty splits)
    boundary = (4, 16, 16, 64, 16, 24)
    for quantized in (False, True):
        cases.append((f"split boundaries {boundary} int8={quantized}", boundary,
                      torch.bfloat16, dict(lengths=[64, 65, 128, 1], quantized=quantized), {}))
    cases.append((f"split boundaries {boundary} window=64", boundary, torch.bfloat16,
                  dict(lengths=[63, 129, 256, 384]), dict(window=64)))
    wide = (3, 16, 16, 64, 16, 40)
    cases.append((f"wide table {wide}", wide, torch.bfloat16,
                  dict(lengths=[200, 17, 97]), {}))
    cases.append((f"wide table {wide} f32 no new token", wide, torch.float32,
                  dict(lengths=[200, 17, 97], with_new=False), {}))
    # dbrx-132b's decode at full width: 48 query heads over 8 KV heads of
    # 128 (a group of 6, covered in blocks of 4 heads), the main table
    dbrx = (3, 48, 8, 128, 16, 24)
    for quantized in (False, True):
        cases.append((f"dbrx {dbrx} int8={quantized}", dbrx, torch.bfloat16,
                      dict(lengths=MAIN_LENGTHS, quantized=quantized), {}))
    wide_gqa = (2, 32, 4, 128, 16, 32)
    cases.append((f"wide table gqa {wide_gqa} softcap", wide_gqa, torch.bfloat16,
                  dict(lengths=[300, 129]), dict(softcap=30.0)))
    cases.append((f"wide table gqa {wide_gqa} int8", wide_gqa, torch.float32,
                  dict(lengths=[300, 129], quantized=True), {}))
    # zamba2's shared-block decode at full width: D = 160, where a key spans
    # 20 lanes (one key a warp step); lengths at and across the 80-key splits
    # of its 25-column table, in bf16, f32 and int8 pages
    for pages, dtype, quantized, lengths in (
            ("bf16", torch.bfloat16, False, [80, 81]), ("f32", torch.float32, False, [160, 1]),
            ("int8", torch.bfloat16, True, [161, 400])):
        cases.append((f"d160 {D160_SHAPE} {pages} pages lengths={lengths}", D160_SHAPE, dtype,
                      dict(lengths=lengths, quantized=quantized), {}))
    # 30-token pages (whisper's cross cache): a permuted table, a full row
    # and rows that end inside a page, with and without a new token
    t30 = (2, 16, 16, 64, 30, 50)
    cases.append((f"T=30 {t30} bf16 lengths=[1500, 777]", t30, torch.bfloat16,
                  dict(lengths=[1500, 777]), {}))
    cases.append((f"T=30 {t30} f32 no new token lengths=[1500, 31]", t30, torch.float32,
                  dict(lengths=[1500, 31], with_new=False), {}))
    main_err = 0.0
    for name, shape, dtype, case_kw, attn_kw in cases:
        c = make_case(rng, shape, dtype, **case_kw)
        out = run_kernel(ops, c, **attn_kw)
        torch.cuda.synchronize()
        want = run_plain(ref, c, **attn_kw)
        err = check_close(f"paged {name}", out, want, ATOL[str(dtype).removeprefix("torch.")])
        if name.startswith("main") and "int8=False" in name:
            main_err = err
    check_gemma2_decode_cases()
    check_cross_decode_cases()
    return main_err


def check_gemma2_decode_cases() -> None:
    """gemma2-9b's decode attention at full width, as phase 8 runs it:
    slot caches read as 16-token pages through ``decode_attention`` (the
    kernel), against the paged kernel's plain version over the same view,
    with f32 and bf16 caches. The 4096-slot local ring (one full, wrapped
    row and one of 1016 slots), the 4624-slot global cache (289 pages) at
    the lengths phase 8 reaches, and the same slots under the 4096 window
    (the full-size local cache). q is scaled (``GEMMA2_DECODE``) so the
    logits reach the softcap, and each case checks that its band would
    reject the plain version without the softcap and, where the window
    binds, without the window."""
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models.layers import decode_attention, slot_pages

    g = GEMMA2_DECODE
    B, H, KH, D, T, cap = g["B"], g["H"], g["KH"], g["D"], 16, g["cap"]
    rng = np.random.default_rng(13)
    cases = (("ring", g["ring"], [g["ring"], g["lengths"][1]], None),
             ("global", g["slots"], g["lengths"], None),
             ("full-size local", g["slots"], g["lengths"], g["window"]))
    for name, S, lengths, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (B, H, D), dtype, scale=g["q_scale"])
            k, v = (randn_dev(rng, (B, S, KH, D), dtype) for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
            got = decode_attention(q, k, v, lengths=lens, window=window, cap=cap, page_tokens=T)
            torch.cuda.synchronize()
            (kp, table), (vp, _) = slot_pages(k, T), slot_pages(v, T)

            def plain(**kw):
                return ref.paged_attention_ref(q, kp, vp, table, lens, **kw).reshape(B, H * D)

            label = (f"paged gemma2 {name} B={B} H={H} KH={KH} S={S} D={D} lengths={lengths} "
                     f"window={window} softcap={cap} q*{g['q_scale']} {dtype}")
            atol = ATOL[str(dtype).removeprefix("torch.")]
            want = plain(softcap=cap, window=window)
            check_close(label, got, want, atol)
            without = {"softcap": plain(window=window)}
            if window is not None:
                without["window"] = plain(softcap=cap)
            check_band_binds(label, want, without, atol)


def check_cross_decode_cases() -> None:
    """whisper-medium's cross-attention decode as phase 8 runs it: a cross
    cache of 1500 encoder positions read through ``decode_attention`` as
    pages of ``dividing_page_tokens(1500)`` = 30 tokens, every position
    visible, with f32 and bf16 caches, against the paged kernel's plain
    version over the same view."""
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models.layers import decode_attention, dividing_page_tokens, slot_pages

    c = CROSS_DECODE
    B, H, KH, D, S = c["B"], c["H"], c["KH"], c["D"], c["S"]
    T = dividing_page_tokens(S)
    if T != 30:
        raise AssertionError(f"whisper's cross cache would be read in pages of {T}, not 30")
    rng = np.random.default_rng(15)
    for dtype in (torch.float32, torch.bfloat16):
        q = randn_dev(rng, (B, H, D), dtype)
        k, v = (randn_dev(rng, (B, S, KH, D), dtype) for _ in range(2))
        lens = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
        got = decode_attention(q, k, v, lengths=lens, page_tokens=T)
        torch.cuda.synchronize()
        (kp, table), (vp, _) = slot_pages(k, T), slot_pages(v, T)
        want = ref.paged_attention_ref(q, kp, vp, table, lens).reshape(B, H * D)
        check_close(f"paged whisper cross B={B} H={H} KH={KH} S={S} T={T} D={D} {dtype}", got,
                    want, ATOL[str(dtype).removeprefix("torch.")])


def time_cross_decode() -> dict:
    """whisper-medium's cross-attention decode (``CROSS_DECODE``), bf16:
    the kernel through ``decode_attention`` over ``layers`` distinct cross
    caches a round (as a decode step walks the layers, so they do not sit
    in L2), each read as 30-token pages; its plain version over the same
    views; and SDPA over the caches in [B, H, S, D] with no mask (every
    position is visible), the transposes not timed."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.layers import decode_attention, dividing_page_tokens, slot_pages

    c = CROSS_DECODE
    B, H, KH, D, S, L = c["B"], c["H"], c["KH"], c["D"], c["S"], c["layers"]
    T = dividing_page_tokens(S)
    rng = np.random.default_rng(16)
    q = randn_dev(rng, (B, H, D), torch.bfloat16)
    caches = [tuple(randn_dev(rng, (B, S, KH, D), torch.bfloat16) for _ in range(2))
              for _ in range(L)]
    views = [(slot_pages(k, T), slot_pages(v, T)) for k, v in caches]
    lens = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
    dense = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
             for k, v in caches]
    qd = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel_round():
        for k, v in caches:
            decode_attention(q, k, v, lengths=lens, page_tokens=T)

    def plain_round():
        for (kp, table), (vp, _) in views:
            ref.paged_attention_ref(q, kp, vp, table, lens)

    def library_round():
        for kd, vd in dense:
            sdpa(qd, kd, vd)

    lib = sdpa(qd, *dense[0])[:, :, 0, :].reshape(B, H * D).float()
    kern = decode_attention(q, *caches[0], lengths=lens, page_tokens=T).float()
    lib_err = (lib - kern).abs().max().item()
    log(f"SDPA yardstick vs kernel at whisper's cross decode: max_abs_err {lib_err:.3e}")
    if not lib_err <= ATOL["bfloat16"] * (1 + kern.abs().max().item()):
        raise AssertionError("the SDPA yardstick computes another function")
    kernel_ms = time_call(kernel_round, 20) / L
    plain_ms = time_call(plain_round, 3) / L
    library_ms = time_call(library_round, 20) / L

    def kernel_rounds():
        for _ in range(10):
            kernel_round()

    def library_rounds():
        for _ in range(10):
            library_round()

    device = device_ms_per_call(kernel_rounds, 10 * L, PAGED_KERNEL_NAMES)
    library_device = device_ms_per_call(library_rounds, 10 * L, None)
    splits, cols = ops._split_plan(S // T, T, ops.KERNEL.sm_count(q.device), B * KH)
    (k_pages, table), _ = views[0]
    return dict(B=B, H=H, KH=KH, D=D, S=S, page_tokens=T, layers=L, ms=kernel_ms, **device,
                splits=splits, cols_per_split=cols, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device["device_ms"],
                library_kernels_ms=library_device["device_kernels_ms"],
                **bound_of(ops.cost(q, k_pages, table, lens)))


def time_kernel(layers: int, shape=MAIN_SHAPE, lengths=MAIN_LENGTHS):
    """Kernel, plain version and SDPA at ``shape`` (the serving path's by
    default) and ``lengths``, over ``layers`` distinct layer slices of the
    pool per call round (as one decode step walks the layers, so the pages
    do not sit in L2)."""
    from repro_torch.kernels.paged_attention import ops, ref

    rng = np.random.default_rng(1)
    c = make_case(rng, shape, torch.bfloat16, lengths=lengths, layers=layers)
    B, H, KH, D, T, P = shape

    def kernel_round():
        for l in range(layers):
            run_kernel(ops, c, layer=l)

    def plain_round():
        for l in range(layers):
            run_plain(ref, c, layer=l)

    # the library yardstick: SDPA over the densely gathered context with
    # the new token in place and the ragged tail masked (gather not timed)
    lens = c["lengths"].long()
    S = P * T
    dense = []
    for l in range(layers):
        idx = c["tables"].long()
        kd = c["k"][l][idx].reshape(B, S, KH, D).clone()
        vd = c["v"][l][idx].reshape(B, S, KH, D).clone()
        rows = torch.arange(B, device=DEVICE)
        kd[rows, lens - 1] = c["k_new"]
        vd[rows, lens - 1] = c["v_new"]
        dense.append((kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()))
    mask = (torch.arange(S, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]
    qd = c["q"][:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_round():
        for kd, vd in dense:
            sdpa(qd, kd, vd, attn_mask=mask)

    # the yardstick must compute the same function as the kernel
    lib_out = sdpa(qd, dense[0][0], dense[0][1], attn_mask=mask)[:, :, 0, :].float()
    kern_out = run_kernel(ops, c, layer=0).float()
    lib_err = (lib_out - kern_out).abs().max().item()
    log(f"SDPA yardstick vs kernel at {shape}: max_abs_err {lib_err:.3e}")
    if not lib_err <= ATOL["bfloat16"] * (1 + kern_out.abs().max().item()):
        raise AssertionError("the SDPA yardstick computes another function")

    kernel_ms = time_call(kernel_round, 50) / layers
    plain_ms = time_call(plain_round, 5) / layers
    library_ms = time_call(library_round, 50) / layers

    def kernel_rounds():
        for _ in range(20):
            kernel_round()

    def library_rounds():
        for _ in range(20):
            library_round()

    device = device_ms_per_call(kernel_rounds, 20 * layers,
                                ("paged_split_kernel", "paged_combine_kernel"))
    library_device = device_ms_per_call(library_rounds, 20 * layers, None)
    splits, cols = ops._split_plan(P, T, ops.KERNEL.sm_count(c["q"].device), B * KH)

    # least time for one call (``ops.cost``): the data decides what is
    # needed (the visible positions of each row, the new token from its
    # operand)
    lengths = np.asarray(lengths)
    return dict(shape=shape, lengths=lengths.tolist(), layers=layers,
                ms=kernel_ms, **device, splits=splits, cols_per_split=cols,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device["device_ms"],
                library_kernels_ms=library_device["device_kernels_ms"],
                **bound_of(ops.cost(c["q"], c["k"][0], c["tables"], lengths,
                                    k_new=c["k_new"])))


# ------------------------------------------------------------ phase 2: flash
def randn_dev(rng, shape, dtype, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) * scale).to(
        DEVICE).to(dtype)


def chunk_prefill_case(rng, dtype=torch.bfloat16):
    """The chunked-prefill attention of the serving path: q [B,Sq,H,D] at
    positions Sp.., k/v over the padded prefix and the chunk, the padding
    [prefix_valid, Sp) masked as a hole."""
    c = FLASH_CHUNK
    q = randn_dev(rng, (c["B"], c["Sq"], c["H"], c["D"]), dtype)
    k = randn_dev(rng, (c["B"], c["Sp"] + c["Sq"], c["KH"], c["D"]), dtype)
    v = randn_dev(rng, (c["B"], c["Sp"] + c["Sq"], c["KH"], c["D"]), dtype)
    kw = dict(causal=True, q_offset=c["Sp"], kv_hole=(c["prefix_valid"], c["Sp"]))
    return q, k, v, kw


def check_flash_cases():
    """Flash attention against its plain versions: ``flash_attention``
    ([B,H,S,D]) against ``flash_attention_ref`` and ``prefill_attention``
    ([B,S,H,D]) against ``blockwise_attention``. Returns the largest error
    at the serving path's two prefill shapes."""
    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(3)
    for B, H, KH, S, D in FLASH_SHAPES:
        for variant, kw in FLASH_VARIANTS.items():
            for dtype in (torch.float32, torch.bfloat16):
                q = randn_dev(rng, (B, H, S, D), dtype)
                k = randn_dev(rng, (B, KH, S, D), dtype)
                v = randn_dev(rng, (B, KH, S, D), dtype)
                out = ops.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                check_close(f"flash {(B, H, KH, S, D)} {variant} {dtype}", out,
                            ref.flash_attention_ref(q, k, v, **kw),
                            ATOL[str(dtype).removeprefix("torch.")])
    # [B,H,S,D] cases the Pallas kernel cannot take: ragged lengths, a
    # long bidirectional encoder (whisper's 1500 frames), q_offset chunks
    bhsd = [
        ("ragged 100 causal", (1, 4, 4, 100, 100, 64), dict(causal=True)),
        ("ragged 100 window", (2, 8, 2, 100, 100, 64), dict(causal=True, window=33)),
        ("bidir 1500", (1, 16, 16, 1500, 1500, 64), dict(causal=False)),
        ("q_offset chunk", (1, 8, 8, 37, 101, 64), dict(causal=True, q_offset=64)),
        ("q_offset window softcap", (1, 8, 4, 64, 192, 128),
         dict(causal=True, q_offset=128, window=80, softcap=30.0)),
    ]
    for name, (B, H, KH, Sq, Skv, D), kw in bhsd:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (B, H, Sq, D), dtype)
            k = randn_dev(rng, (B, KH, Skv, D), dtype)
            v = randn_dev(rng, (B, KH, Skv, D), dtype)
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check_close(f"flash {name} {dtype}", out, ref.flash_attention_ref(q, k, v, **kw),
                        ATOL[str(dtype).removeprefix("torch.")])
    # the model's layout against blockwise_attention: kv_hole, kv_lengths,
    # GQA 4:1, MQA, D=128, and the serving path's two prefill shapes
    m = FLASH_MAIN
    bshd = [
        ("hole", (1, 48, 112, 8, 8, 64), dict(causal=True, q_offset=64, kv_hole=(41, 64))),
        ("kv_lengths gqa4", (3, 40, 72, 16, 4, 64),
         dict(causal=True, q_offset=32, kv_lengths=[72, 50, 33])),
        ("mqa d128", (2, 70, 70, 8, 1, 128), dict(causal=True)),
        ("mqa window softcap", (1, 96, 96, 8, 1, 64), dict(causal=True, window=20, cap=50.0)),
        ("main monolithic", (m["B"], m["S"], m["S"], m["H"], m["KH"], m["D"]),
         dict(causal=True)),
    ]
    main_err = 0.0
    for name, (B, Sq, Skv, H, KH, D), kw in bshd:
        if "kv_lengths" in kw:
            kw = dict(kw, kv_lengths=torch.tensor(kw["kv_lengths"], dtype=torch.int32,
                                                  device=DEVICE))
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (B, Sq, H, D), dtype)
            k = randn_dev(rng, (B, Skv, KH, D), dtype)
            v = randn_dev(rng, (B, Skv, KH, D), dtype)
            out = ops.prefill_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_close(f"prefill {name} {dtype}", out,
                              ref.blockwise_attention(q, k, v, **kw),
                              ATOL[str(dtype).removeprefix("torch.")])
            if name.startswith("main") and dtype == torch.bfloat16:
                main_err = max(main_err, err)
    q, k, v, kw = chunk_prefill_case(rng)
    out = ops.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close("prefill main chunk over a bucketed prefix", out,
                      ref.blockwise_attention(q, k, v, **kw), ATOL["bfloat16"])
    # the layouts share the kernel: [B,H,S,D] views of the same data agree
    out_bhsd = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True, q_offset=kw["q_offset"])
    ref_bhsd = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True, q_offset=kw["q_offset"])
    check_close("flash strided [B,H,S,D] views", out_bhsd, ref_bhsd, ATOL["bfloat16"])
    # the bf16 tensor-core path: every head dimension, GQA, ragged Sq and
    # Skv tails, a hole with q_offset, and operands whose row starts are
    # not 16-byte aligned (they take the CUDA-core kernel in bf16)
    bf16 = [
        ("d32 ragged", (2, 77, 77, 4, 4, 32), dict(causal=True)),
        ("d64 ragged tail bidir", (1, 130, 201, 8, 8, 64), dict(causal=False)),
        ("d128 ragged", (1, 100, 100, 4, 4, 128), dict(causal=True)),
        ("d128 gqa window softcap", (2, 150, 150, 8, 2, 128),
         dict(causal=True, window=70, cap=30.0)),
        ("gqa4 ragged q_offset", (1, 45, 173, 16, 4, 64), dict(causal=True, q_offset=128)),
        ("hole q_offset gqa", (2, 64, 192, 8, 2, 64),
         dict(causal=True, q_offset=128, kv_hole=(83, 128))),
        ("hole q_offset d32", (1, 33, 161, 4, 4, 32),
         dict(causal=True, q_offset=128, kv_hole=(64, 128))),
        ("dbrx gqa 6:1", (1, 384, 384, 48, 8, 128), dict(causal=True)),
        ("dbrx gqa 6:1 chunk hole", (1, 64, 192, 48, 8, 128),
         dict(causal=True, q_offset=128, kv_hole=(100, 128))),
    ]
    for name, (B, Sq, Skv, H, KH, D), kw in bf16:
        q = randn_dev(rng, (B, Sq, H, D), torch.bfloat16)
        k = randn_dev(rng, (B, Skv, KH, D), torch.bfloat16)
        v = randn_dev(rng, (B, Skv, KH, D), torch.bfloat16)
        out = ops.prefill_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check_close(f"prefill bf16 {name}", out, ref.blockwise_attention(q, k, v, **kw),
                    ATOL["bfloat16"])
    # head dimensions beyond 128, on both kernels: zamba2's shared block
    # (D = 160, 32 heads) and gemma2-9b (D = 256, GQA 2:1), causal with a
    # ragged tail, and a chunk at q_offset behind a kv_hole
    wide_d = [
        ("d160 ragged", (1, 200, 200, 32, 32, 160), dict(causal=True)),
        ("d160 chunk hole", (1, 64, 192, 32, 32, 160),
         dict(causal=True, q_offset=128, kv_hole=(83, 128))),
        ("d256 ragged", (1, 200, 200, 16, 8, 256), dict(causal=True)),
        ("d256 chunk hole", (1, 64, 192, 16, 8, 256),
         dict(causal=True, q_offset=128, kv_hole=(83, 128))),
    ]
    for name, (B, Sq, Skv, H, KH, D), kw in wide_d:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (B, Sq, H, D), dtype)
            k = randn_dev(rng, (B, Skv, KH, D), dtype)
            v = randn_dev(rng, (B, Skv, KH, D), dtype)
            out = ops.prefill_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check_close(f"prefill {name} {dtype}", out, ref.blockwise_attention(q, k, v, **kw),
                        ATOL[str(dtype).removeprefix("torch.")])
    # gemma2-9b's local layers at its phase-8 prompt: the 4096-token window
    # binds at 4600 tokens, with softcap 50; and a chunk behind a hole. q
    # is scaled so the logits reach the softcap, and each band must reject
    # the plain version without the window and without the softcap
    g = FLASH_GEMMA2
    local = dict(causal=True, window=g["window"], cap=g["cap"])
    gemma2 = [
        ("gemma2 local", (g["B"], g["S"], g["S"], g["H"], g["KH"], g["D"]), local),
        ("gemma2 local chunk hole", (1, 64, 4224, g["H"], g["KH"], g["D"]),
         dict(local, q_offset=4160, kv_hole=(4100, 4160))),
    ]
    for name, (B, Sq, Skv, H, KH, D), kw in gemma2:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (B, Sq, H, D), dtype, scale=g["q_scale"])
            k = randn_dev(rng, (B, Skv, KH, D), dtype)
            v = randn_dev(rng, (B, Skv, KH, D), dtype)
            out = ops.prefill_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            label = f"prefill {name} {(B, Sq, Skv, H, KH, D)} {kw} q*{g['q_scale']} {dtype}"
            atol = ATOL[str(dtype).removeprefix("torch.")]
            want = ref.blockwise_attention(q, k, v, **kw)
            check_close(label, out, want, atol)
            check_band_binds(label, want, {
                feature: ref.blockwise_attention(
                    q, k, v, **{n: x for n, x in kw.items() if n != feature})
                for feature in ("window", "cap")}, atol)
    # phase 8's whisper encoder, its cross-attention prefill and internvl2's
    # prefill, at full width, in f32 and bf16. Each band must reject the
    # plain version without the ragged last kv tile (1500 = 23 tiles of 64
    # and 28; 856 = 13 and 24), and the bidirectional cases' bands the
    # plain version with a causal mask
    for name, c in FLASH_MODELS.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = randn_dev(rng, (c["B"], c["Sq"], c["H"], c["D"]), dtype)
            k, v = (randn_dev(rng, (c["B"], c["Skv"], c["KH"], c["D"]), dtype) for _ in range(2))
            kw = dict(causal=c["causal"])
            out = ops.prefill_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            label = (f"prefill {name} {(c['B'], c['Sq'], c['Skv'], c['H'], c['KH'], c['D'])} "
                     f"{kw} {dtype}")
            atol = ATOL[str(dtype).removeprefix("torch.")]
            want = ref.blockwise_attention(q, k, v, **kw)
            check_close(label, out, want, atol)
            whole_tiles = torch.full((c["B"],), c["Skv"] - c["Skv"] % FLASH_KV_TILE,
                                     dtype=torch.int32, device=DEVICE)
            without = {"the ragged kv tile": ref.blockwise_attention(
                q, k, v, kv_lengths=whole_tiles, **kw)}
            if not c["causal"]:
                without["bidirection"] = ref.blockwise_attention(q, k, v, causal=True)
            check_band_binds(label, want, without, atol)
    wide = randn_dev(rng, (3, 90, 8, 65), torch.bfloat16)
    q, k, v = (wide[i:i + 1, ..., :64] for i in range(3))
    out = ops.prefill_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check_close("prefill bf16 unaligned strides (CUDA-core kernel)", out,
                ref.blockwise_attention(q, k, v, causal=True), ATOL["bfloat16"])
    return max(main_err, err)


def time_flash():
    """Kernel, plain version and SDPA (explicit boolean mask; GQA through
    its ``enable_gqa``) at the serving path's monolithic prefill shape, the
    chunk shape, a long causal prefill (``FLASH_LONG_S``), the prompts
    of ``FLASH_OTHER``, gemma2's local layer (``FLASH_GEMMA2``, whose
    softcap SDPA cannot compute: :func:`time_flex_yardstick` adds its
    library time at the end of the run) and phase 8's whisper and
    internvl2 shapes (``FLASH_MODELS``, SDPA without a mask tensor)."""
    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    m = FLASH_MAIN
    mono = (randn_dev(rng, (m["B"], m["S"], m["H"], m["D"]), torch.bfloat16),
            randn_dev(rng, (m["B"], m["S"], m["KH"], m["D"]), torch.bfloat16),
            randn_dev(rng, (m["B"], m["S"], m["KH"], m["D"]), torch.bfloat16),
            dict(causal=True))
    chunk = chunk_prefill_case(rng)
    long_case = tuple(randn_dev(rng, (m["B"], FLASH_LONG_S, m["H"], m["D"]), torch.bfloat16)
                      for _ in range(3)) + (dict(causal=True),)
    cases = [("monolithic", mono), ("chunk", chunk), ("long", long_case)]
    for name, c in FLASH_OTHER.items():
        cases.append((name, (randn_dev(rng, (c["B"], c["S"], c["H"], c["D"]), torch.bfloat16),
                             randn_dev(rng, (c["B"], c["S"], c["KH"], c["D"]), torch.bfloat16),
                             randn_dev(rng, (c["B"], c["S"], c["KH"], c["D"]), torch.bfloat16),
                             dict(causal=True))))
    cases.append(("gemma2_local", gemma2_local_case()))
    for name, c in FLASH_MODELS.items():
        cases.append((name, (randn_dev(rng, (c["B"], c["Sq"], c["H"], c["D"]), torch.bfloat16),
                             randn_dev(rng, (c["B"], c["Skv"], c["KH"], c["D"]), torch.bfloat16),
                             randn_dev(rng, (c["B"], c["Skv"], c["KH"], c["D"]), torch.bfloat16),
                             dict(causal=c["causal"]))))
    for name, (q, k, v, kw) in cases:
        B, Sq, H, D = q.shape
        Skv, KH = k.shape[1], k.shape[2]
        q_off = kw.get("q_offset", 0)
        qpos = q_off + torch.arange(Sq, device=DEVICE)[:, None]
        kpos = torch.arange(Skv, device=DEVICE)[None, :]
        mask = qpos >= kpos if kw["causal"] else torch.ones_like(qpos >= kpos)
        if "window" in kw:
            mask &= (qpos - kpos) < kw["window"]
        if "kv_hole" in kw:
            lo, hi = kw["kv_hole"]
            mask &= ~((kpos >= lo) & (kpos < hi))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # SDPA's keywords: GQA through its enable_gqa; FLASH_MODELS' cases
        # without a mask tensor, the others with the explicit mask
        lib_kw = dict(enable_gqa=True) if KH != H else {}
        if name not in FLASH_MODELS:
            lib_kw.update(attn_mask=mask)
        elif kw["causal"]:
            lib_kw.update(is_causal=True)
        # SDPA has no softcap: the softcapped case's library (compiled
        # flex_attention) is timed by ``time_flex_yardstick`` at the end
        library = "cap" not in kw
        if library:
            lib = sdpa(qt, kt, vt, **lib_kw).transpose(1, 2)
            check_yardstick(f"scaled_dot_product_attention ({name})", lib,
                            ops.prefill_attention(q, k, v, **kw))

        def calls():
            for _ in range(50):
                ops.prefill_attention(q, k, v, **kw)

        def library_calls():
            for _ in range(50):
                sdpa(qt, kt, vt, **lib_kw)

        if library:
            library_device = device_ms_per_call(library_calls, 50, None)
            lib_rec = dict(library="scaled_dot_product_attention",
                           library_ms=time_call(lambda: sdpa(qt, kt, vt, **lib_kw), 50),
                           library_device_ms=library_device["device_ms"],
                           library_kernels_ms=library_device["device_kernels_ms"])
        else:
            lib_rec = {}
        out[name] = dict(
            ms=time_call(lambda: ops.prefill_attention(q, k, v, **kw), 50),
            **device_ms_per_call(calls, 50, ("flash_mma_kernel", "flash_attention_kernel")),
            plain_ms=time_call(lambda: ref.blockwise_attention(q, k, v, **kw), 10),
            **lib_rec, B=B, Sq=Sq, Skv=Skv, H=H, KH=KH, D=D, causal=kw["causal"],
            window=kw.get("window"), softcap=kw.get("cap"), q_offset=kw.get("q_offset", 0),
            kv_hole=kw.get("kv_hole"), **bound_of(ops.prefill_cost(q, k, v, **kw)))
        if not all("flash_mma_kernel" in k for k in out[name]["device_kernels_ms"]):
            raise AssertionError(f"bf16 prefill ({name}) did not run the tensor-core kernel")
    return out


def gemma2_local_case():
    """gemma2-9b's local-layer prefill attention (``FLASH_GEMMA2``) in bf16,
    from its own seed: q, k, v [B, S, H, D] and the keywords."""
    g = FLASH_GEMMA2
    rng = np.random.default_rng(14)
    q = randn_dev(rng, (g["B"], g["S"], g["H"], g["D"]), torch.bfloat16, scale=g["q_scale"])
    k, v = (randn_dev(rng, (g["B"], g["S"], g["KH"], g["D"]), torch.bfloat16) for _ in range(2))
    return q, k, v, dict(causal=True, window=g["window"], cap=g["cap"])


def check_yardstick(name: str, lib, kern) -> None:
    """A library yardstick must compute the kernel's function."""
    lib, kern = lib.float(), kern.float()
    err = (lib - kern).abs().max().item()
    log(f"{name} yardstick vs flash kernel: max_abs_err {err:.3e}")
    if not err <= ATOL["bfloat16"] * (1 + kern.abs().max().item()):
        raise AssertionError(f"the {name} yardstick computes another function")


def time_flex_yardstick(timing: dict) -> None:
    """The library time of gemma2's local layer (``timing``'s
    ``gemma2_local`` entry gains it): compiled ``flex_attention`` with the
    softcap and the causal window, on the inputs ``time_flash`` timed the
    kernel on. Run it after every other profile: once ``torch.compile``
    has run, a profile has come back one or two kernel records short."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v, kw = gemma2_local_case()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t0 = time.perf_counter()
    library = flex_softcap_attention(kw, q.shape[1], k.shape[1])
    lib = library(qt, kt, vt).transpose(1, 2)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check_yardstick("flex_attention (gemma2_local)", lib, ops.prefill_attention(q, k, v, **kw))

    def library_calls():
        for _ in range(50):
            library(qt, kt, vt)

    device = device_ms_per_call(library_calls, 50, None)
    rec = dict(library="flex_attention (torch.compile)", library_compile_s=compile_s,
               library_ms=time_call(lambda: library(qt, kt, vt), 50),
               library_device_ms=device["device_ms"],
               library_kernels_ms=device["device_kernels_ms"],
               library_profiled_instances=device["profiled_instances"])
    timing["gemma2_local"].update(rec)
    log("flash gemma2_local library " + json.dumps(rec))


def flex_softcap_attention(kw: dict, Sq: int, Skv: int):
    """The library yardstick where SDPA has no softcap: ``flex_attention``,
    compiled (its eager form is an unfused reference), with the softcap as
    its score modifier and causal-window visibility as its block mask.
    Returns ``f(q, k, v)`` on ``[B, H, S, D]`` operands (GQA allowed)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if kw.get("q_offset", 0) or "kv_hole" in kw or not kw.get("causal"):
        raise ValueError(f"the flex yardstick covers causal prompts from 0 only: {kw}")
    cap, window = kw["cap"], kw.get("window")

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        visible = q_idx >= kv_idx
        if window is not None:
            visible = visible & (q_idx - kv_idx < window)
        return visible

    import torch._inductor.config as inductor_config

    inductor_config.compile_threads = 1      # compile here: no worker processes to stop
    block_mask = create_block_mask(mask_mod, None, None, Sq, Skv, device=DEVICE)
    compiled = torch.compile(flex_attention)

    def library(q, k, v):
        return compiled(q, k, v, score_mod=score_mod, block_mask=block_mask,
                        enable_gqa=k.shape[1] != q.shape[1])

    return library


# ------------------------------------------------------------ phase 2: ssd
def ssd_inputs(rng, b, s, h, p, n, x_dtype, bc_dtype, realistic=False, fused=False):
    """x, dt (after softplus), A (negative), B, C [b,s,n] on the card.
    ``realistic`` scales them as the model's are: dt around 0.05 (mamba2's
    dt_bias puts it in [0.001, 0.1]) and C by n**-0.5, which keeps y at
    O(1), so the bf16 band is one of O(1) values. ``fused`` makes x, B and
    C strided slices of one [b, s, h*p + 2n] tensor, as the model's conv
    output gives them (x and B/C then share ``x_dtype``)."""
    if fused:
        xbc = randn_dev(rng, (b, s, h * p + 2 * n), x_dtype)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        if realistic:
            C = C * n ** -0.5
    else:
        x = randn_dev(rng, (b, s, h, p), x_dtype)
        B = randn_dev(rng, (b, s, n), bc_dtype)
        C = randn_dev(rng, (b, s, n), bc_dtype, scale=n ** -0.5 if realistic else 1.0)
    dt_pre = randn_dev(rng, (b, s, h), torch.float32)
    dt = torch.nn.functional.softplus(dt_pre - 3.0 if realistic else dt_pre)
    A = -randn_dev(rng, (h,), torch.float32).abs()
    return x, dt, A, B, C


def check_ssd_cases():
    """The SSD kernel against ``ssd_reference`` (y at the reference's
    bands, the final state at 1e-2) on both routes, the tensor-core route
    also against the passes' plain version (``ssd_chunked_passes_ref``),
    and against ``ssd_naive`` at a tiny shape. Each case asserts the route
    it took. Returns the largest y error at the full-width shape."""
    from repro_torch.kernels.ssd import ops, ref

    rng = np.random.default_rng(5)
    m = SSD_MAIN
    main = (m["b"], m["h"], m["p"], m["n"])
    core, tc = "cuda_core", "tensor_core"
    bf16, f32 = torch.bfloat16, torch.float32
    # name, (b, s, h, p, n), chunk, x dtype, B/C dtype, route
    cases = [(f"{shape}", shape[:5], shape[5], dtype, f32, core)
             for shape in SSD_SHAPES for dtype in (f32, bf16)]
    cases += [
        ("ragged S=200 chunk=128", (1, 200, 4, 32, 64), 128, bf16, bf16, tc),
        ("ragged S=77 chunk=16 f32", (2, 77, 2, 16, 32), 16, f32, f32, core),
        ("main S=200", (main[0], 200, *main[1:]), m["chunk"], bf16, bf16, tc),
        (f"main S={SSD_MAIN_S}", (main[0], SSD_MAIN_S, *main[1:]), m["chunk"], bf16, bf16, tc),
        (f"main S={SSD_MAIN_S} cuda-core route", (main[0], SSD_MAIN_S, *main[1:]), m["chunk"],
         bf16, bf16, core),
        ("main S=1", (main[0], 1, *main[1:]), m["chunk"], bf16, bf16, tc),
        ("main S=128 one chunk", (main[0], 128, *main[1:]), m["chunk"], bf16, bf16, tc),
        ("main B=2 S=200", (2, 200, *main[1:]), m["chunk"], bf16, bf16, tc),
        ("main fused slices S=200", (main[0], 200, *main[1:]), m["chunk"], bf16, bf16, tc),
        ("main chunk=64 S=200", (main[0], 200, *main[1:]), 64, bf16, bf16, tc),
        ("main chunk=256 S=300", (main[0], 300, *main[1:]), 256, bf16, bf16, tc),
        # zamba2's widths: state 64, its two prompt lengths
        ("main zamba2 N=64 S=384", (1, 384, 80, 64, 64), 128, bf16, bf16, tc),
        ("main zamba2 N=64 S=200 fused slices", (1, 200, 80, 64, 64), 128, bf16, bf16, tc),
        # the reference's own input scales at mamba2's widths: larger y, the
        # band relative to it
        ("unscaled S=1024", (main[0], 1024, *main[1:]), m["chunk"], bf16, bf16, tc),
    ]
    main_err = 0.0
    for name, (b, s, h, p, n), chunk, x_dtype, bc_dtype, route in cases:
        x, dt, A, B, C = ssd_inputs(rng, b, s, h, p, n, x_dtype, bc_dtype,
                                    realistic=name.startswith("main"),
                                    fused="fused" in name)
        before = ops.KERNEL.routes[route]
        y, st = ops.KERNEL(x, dt, A, B, C, chunk=chunk, route=route if "route" in name else None)
        torch.cuda.synchronize()
        if ops.KERNEL.routes[route] != before + 1:
            raise AssertionError(f"ssd {name} did not take the {route} route")
        yr, sr = ref.ssd_reference(x, dt, A, B[:, :, None], C[:, :, None], chunk=chunk)
        err = check_close(f"ssd {name} x={x_dtype} bc={bc_dtype} {route} y", y, yr,
                          ATOL[str(x_dtype).removeprefix("torch.")])
        check_close(f"ssd {name} final state", st, sr, STATE_ATOL)
        if route == tc:
            yp, sp = ref.ssd_chunked_passes_ref(x, dt, A, B, C, chunk=chunk,
                                                split_operands=True)
            check_close(f"ssd {name} y vs the passes' plain version", y, yp, ATOL["bfloat16"])
            check_close(f"ssd {name} final state vs the passes' plain version", st, sp,
                        STATE_ATOL)
        if name.startswith("main"):
            main_err = max(main_err, err)
    x, dt, A, B, C = ssd_inputs(rng, 1, 24, 2, 4, 8, torch.float32, torch.float32)
    y, st = ops.ssd(x, dt, A, B[:, :, None], C[:, :, None], chunk=8)
    torch.cuda.synchronize()
    yn, sn = ref.ssd_naive(x, dt, A, B[:, :, None], C[:, :, None])
    check_close("ssd tiny vs the sequential scan y", y, yn, ATOL["float32"])
    check_close("ssd tiny vs the sequential scan state", st, sn, ATOL["float32"])
    return main_err


def time_ssd():
    """The kernel at the full-width shape, bf16, at S = 128 (one chunk, the
    replay's common prefill), 200, ``SSD_MAIN_S`` and ``SSD_LONG_S``: its
    event-timed wrapper call (``ms``), the device time of all its passes a
    call (``device_ms``, torch.profiler), the bound, and at ``SSD_MAIN_S``
    the plain version and the CUDA-core route on the same input. Each bf16
    call must have run the tensor-core passes. No single PyTorch call
    computes the scan, so there is no library time."""
    from repro_torch.kernels.ssd import ops, ref

    m = SSD_MAIN
    b, h, p, n, Q = m["b"], m["h"], m["p"], m["n"], m["chunk"]
    rng = np.random.default_rng(6)
    out = {}
    for S in (128, 200, SSD_MAIN_S, SSD_LONG_S):
        x, dt, A, B, C = ssd_inputs(rng, b, S, h, p, n, torch.bfloat16, torch.bfloat16,
                                    realistic=True)

        def calls(route=None, x=x, dt=dt, A=A, B=B, C=C):
            for _ in range(20):
                ops.KERNEL(x, dt, A, B, C, chunk=Q, route=route)

        before = ops.KERNEL.routes["tensor_core"]
        rec = dict(S=S, ms=time_call(lambda: ops.ssd(x, dt, A, B, C, chunk=Q), 20),
                   **device_ms_per_call(calls, 20, SSD_KERNEL_NAMES),
                   **with_f32_ops(ops.cost(x, dt, A, B, C, chunk=Q)))
        if (ops.KERNEL.routes["tensor_core"] == before
                or not all("ssd_tc_" in k for k in rec["device_kernels_ms"])):
            raise AssertionError(f"the bf16 scan at S={S} did not run the tensor-core passes")
        if S == SSD_MAIN_S:
            B4, C4 = B[:, :, None], C[:, :, None]
            rec["plain_ms"] = time_call(lambda: ref.ssd_reference(x, dt, A, B4, C4, chunk=Q), 5)
            core = device_ms_per_call(lambda: calls("cuda_core"), 20, SSD_KERNEL_NAMES)
            rec["cuda_core_ms"] = time_call(
                lambda: ops.KERNEL(x, dt, A, B, C, chunk=Q, route="cuda_core"), 20)
            rec["cuda_core_device_ms"] = core["device_ms"]
            rec["cuda_core_kernels_ms"] = core["device_kernels_ms"]
        out[S] = rec
    main = out[SSD_MAIN_S]
    z = SSD_ZAMBA2
    x, dt, A, B, C = ssd_inputs(rng, z["b"], z["S"], z["h"], z["p"], z["n"], torch.bfloat16,
                                torch.bfloat16, realistic=True)

    def zamba2_calls():
        for _ in range(20):
            ops.KERNEL(x, dt, A, B, C, chunk=z["chunk"])

    before = ops.KERNEL.routes["tensor_core"]
    zamba2 = dict(z, ms=time_call(lambda: ops.ssd(x, dt, A, B, C, chunk=z["chunk"]), 20),
                  **device_ms_per_call(zamba2_calls, 20, SSD_KERNEL_NAMES),
                  plain_ms=time_call(lambda: ref.ssd_reference(
                      x, dt, A, B[:, :, None], C[:, :, None], chunk=z["chunk"]), 5),
                  **with_f32_ops(ops.cost(x, dt, A, B, C, chunk=z["chunk"])))
    if ops.KERNEL.routes["tensor_core"] == before:
        raise AssertionError("the bf16 scan at zamba2's widths did not run the tensor-core passes")
    return dict(main, library_ms=None, library_note="no single PyTorch call computes the SSD scan",
                by_s={S: {k: v for k, v in r.items() if k not in ("bytes_ms", "ops_ms")}
                      for S, r in out.items() if S != SSD_MAIN_S},
                zamba2={k: v for k, v in zamba2.items() if k not in ("bytes_ms", "ops_ms")})


# ------------------------------------------------------------ phase 3
def check_model_small():
    """Reduced qwen: prefill, chunked prefill over a bucketed prefix and
    paged decode on the card (kernels) against the CPU (plain versions),
    same weights, teacher-forced tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    T, n_pages, ctx = 8, 16, 21
    tokens = torch.arange(2, 2 + ctx)[None, :] * 7 % cfg.vocab_size
    chunk = torch.arange(3, 3 + 16)[None, :] * 5 % cfg.vocab_size
    outs = {}
    for dev in ("cpu", DEVICE):
        model = Model(cfg, {k: _to(v, dev) for k, v in params.items()})
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kp = torch.zeros((L, n_pages, T, KH, HD), dtype=torch.bfloat16, device=dev)
        vp = torch.zeros_like(kp)
        logits, cache = model.prefill({"tokens": tokens.to(dev)})
        # chunked prefill over the prefix padded to 32 with a hole
        pad = (0, 0, 0, 0, 0, 32 - ctx)
        prefix = {"k": torch.nn.functional.pad(cache["k"], pad, value=3.0),
                  "v": torch.nn.functional.pad(cache["v"], pad, value=-3.0)}
        chunk_logits, _ = model.prefill({"tokens": chunk.to(dev)}, prefix=prefix,
                                        positions_offset=ctx, prefix_valid=ctx)
        n = -(-ctx // T)
        k_c = torch.nn.functional.pad(cache["k"][:, 0], (0, 0, 0, 0, 0, n * T - ctx))
        v_c = torch.nn.functional.pad(cache["v"][:, 0], (0, 0, 0, 0, 0, n * T - ctx))
        kp[:, :n] = k_c.reshape(L, n, T, KH, HD)
        vp[:, :n] = v_c.reshape(L, n, T, KH, HD)
        step_logits = [logits.float().cpu(), chunk_logits.float().cpu()]
        table = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        table[0, :n + 1] = torch.arange(n + 1, dtype=torch.int32)
        for i in range(6):
            length = ctx + 1 + i
            pos = length - 1
            tok = torch.tensor([(5 + 11 * i) % cfg.vocab_size], device=dev)
            lg = model.decode_paged(
                kp, vp, tok, torch.tensor([length], dtype=torch.int32, device=dev), table,
                torch.tensor([pos // T], device=dev), torch.tensor([pos % T], device=dev),
            )
            step_logits.append(lg.float().cpu())
        outs[dev] = (torch.stack(step_logits), kp.float().cpu())
    compare_model("reduced qwen, prefill + chunked prefill + 6 decode steps", outs)


def check_mamba_small():
    """Reduced mamba2: prefill of a ragged length (the SSD kernel) and
    decode steps on the card against the CPU, same weights,
    teacher-forced tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    cfg = get_config("mamba2-2.7b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    tokens = torch.arange(2, 2 + 45)[None, :] * 7 % cfg.vocab_size
    outs = {}
    for dev in ("cpu", DEVICE):
        model = Model(cfg, {k: _to(v, dev) for k, v in params.items()})
        logits, cache = model.prefill({"tokens": tokens.to(dev)})
        seen = [logits.float().cpu()]
        for i in range(4):
            tok = torch.tensor([(5 + 11 * i) % cfg.vocab_size], device=dev)
            lg, cache = model.decode(cache, tok, torch.tensor([46 + i], device=dev))
            seen.append(lg.float().cpu())
        outs[dev] = (torch.stack(seen), cache["ssm"].float().cpu(), cache["conv"].float().cpu())
    compare_model("reduced mamba2, prefill of 45 tokens + 4 decode steps", outs)


def compare_model(what: str, outs: dict) -> None:
    worst, ok = 0.0, True
    for a, b in zip(outs["cpu"], outs[DEVICE]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite values from the card")
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        ok &= bool((diff <= MODEL_ATOL + MODEL_RTOL * a.abs()).all())
    log(f"model on the card vs the CPU ({what}): max_abs_err {worst:.3e} "
        f"(atol={MODEL_ATOL}, rtol={MODEL_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"model on the card disagrees with the CPU ({what})")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _param_tree(model) -> dict:
    """The nested parameter dict a model holds (its buffers, shared)."""
    out: dict = {}
    for name, t in model.params.named_buffers():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return out


def device_kernel_counts(fn, names: tuple) -> tuple[object, dict]:
    """Run ``fn`` under ``torch.profiler`` (device activity only) and
    count the device kernels whose name holds each of ``names``: a
    kernel inside a replayed graph counts as one where a wrapper call
    would. Returns ``fn``'s result and the counts; ``counts["fn_s"]`` is
    ``fn``'s host-clock time under the profiler (ending in a
    synchronize), ``counts["processing_s"]`` the profiler's own time after
    it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        fn_s = time.perf_counter() - t0
    counts = dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in ev.key:
                    counts[name] += ev.count
    counts.update(fn_s=fn_s, processing_s=time.perf_counter() - t0 - fn_s)
    return result, counts


#: the paged-attention kernels: the split pass runs once a wrapper launch,
#: the merge pass only where the table has more than one split
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_combine_kernel")


def paged_device_launches() -> int:
    """The paged kernel's own count of the launches the card ran (its
    split pass adds one to an int32 on the device at each launch, inside
    a replayed graph too)."""
    from repro_torch.kernels.paged_attention import ops

    return ops.KERNEL.device_launches(DEVICE)


def _count_calls(obj, attr: str, counter: dict, key: str, when=lambda result: True):
    """Wrap ``obj.attr`` so that each call whose result passes ``when``
    adds one to ``counter[key]``."""
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        result = fn(*args, **kwargs)
        if when(result):
            counter[key] += 1
        return result

    setattr(obj, attr, wrapped)


# ------------------------------------------------------------ phase 4
def replay_paged(args, chunked: bool, cfg=None, params=None, label="serve", *,
                 engine_kw=None, router_kw=None, replay_kw=None, profile=True,
                 watch=None):
    """One full-width replay of a paged family through the router; returns
    the record, the engines and the router. Without ``cfg`` the launcher
    builds the engines and the router (``serve.build_router``, qwen); with
    ``cfg`` and ``params`` they are built on those weights with the
    launcher's pools and scheduler settings, plus ``engine_kw`` for each
    engine and ``router_kw`` for the router (``config`` replaces the
    launcher's scheduler config). ``chunked`` turns on the router's chunked
    prefill; ``replay_kw`` goes to ``replay`` (faults). With ``profile``
    the replay runs under ``torch.profiler``, which counts the paged
    kernels beside their own device count; ``watch(engines)`` runs after
    warmup, before the replay."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch import serve
    from repro_torch.serving import Engine, MoriRouter

    t0 = time.perf_counter()
    if cfg is None:
        cfg, engines, router = serve.build_router(args)
    else:
        engines = [Engine(cfg, params, device=DEVICE, **serve.ENGINE_POOLS,
                          **(engine_kw or {}))
                   for _ in range(args.replicas)]
        router_kw = dict(router_kw or {})
        router = MoriRouter(
            engines, scheduler=args.scheduler,
            gpu_capacity_bytes=engines[0].pool.page_bytes * args.gpu_pages,  # lint: kv008-ok (GPU budget at device format)
            cpu_capacity_bytes=engines[0].pool.host_page_bytes * args.cpu_pages,
            config=router_kw.pop("config", SchedulerConfig(tick_interval_s=1.0)),
            chunked_prefill=chunked, **router_kw,
        )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # one decode graph per table bucket on every engine before traffic
    # (the chunked replay also runs each chunk bucket once, eagerly)
    t0 = time.perf_counter()
    for e in engines:
        e.warmup(prefill_chunks=chunked)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    corpus = serve.corpus_for(args)
    passes = {"prefill": 0}
    for e in engines:
        _count_calls(e.model, "prefill", passes, "prefill")
    # the counts warmup moved start again from 0
    paged_ops.KERNEL.launches = 0
    flash_ops.KERNEL.launches = 0
    warm_captures = 0
    for e in engines:
        e.graphs.replays = 0
        warm_captures += e.graphs.cache_size()
    # a replayed graph calls no wrapper: the paged kernel counts the
    # launches the card ran on the device itself, and the profiler counts
    # its instances by name beside it
    if watch is not None:
        watch(engines)

    def run():
        return router.replay(corpus, vocab_size=cfg.vocab_size,
                             max_new_tokens=args.max_new_tokens, **(replay_kw or {}))

    ran_before = paged_device_launches()
    if profile:
        m, device_counts = device_kernel_counts(run, PAGED_KERNEL_NAMES)
    else:
        t0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        device_counts = {"fn_s": time.perf_counter() - t0, "processing_s": None,
                         **dict.fromkeys(PAGED_KERNEL_NAMES)}
    paged_eager, flash = paged_ops.KERNEL.launches, flash_ops.KERNEL.launches
    paged = paged_device_launches() - ran_before
    paged_profiled = device_counts["paged_split_kernel"]
    captures = sum(e.graphs.cache_size() for e in engines)
    replays = sum(e.graphs.replays for e in engines)
    engine_steps = sum(e.steps for e in engines)
    full_layers = get_config(cfg.name).num_layers
    record = {
        "arch": cfg.name, "d_model": cfg.d_model,
        "layers": (cfg.num_layers if cfg.num_layers == full_layers
                   else f"{cfg.num_layers} of {full_layers}"),
        "replicas": len(engines), "programs": len(corpus), "chunked_prefill": chunked,
        "steps_completed": m.steps_completed, "tokens_generated": m.tokens_generated,
        "cached_tokens": m.cached_tokens, "prefilled_tokens": m.prefilled_tokens,
        "offloaded_pages": m.offloaded_pages, "reloaded_pages": m.reloaded_pages,
        "gated_events": m.gated_events, "pump_steps": m.pump_steps,
        "prefill_chunks": m.prefill_chunks, "engine_steps": engine_steps,
        "kernel_launches": paged, "kernel_launches_profiler": paged_profiled,
        "paged_launches_eager": paged_eager,
        "paged_combine_kernels": device_counts["paged_combine_kernel"],
        "graph_captures": captures, "post_warmup_captures": captures - warm_captures,
        "graph_replays": replays, "graph_buckets": sorted(
            {k for e in engines for k in e.graphs.keys()}),
        "prefill_passes": passes["prefill"],
        "flash_launches": flash, "setup_s": setup_s, "warmup_s": warmup_s,
        ("replay_s_profiled" if profile else "replay_s"): device_counts["fn_s"],
        "profiler_processing_s": device_counts["processing_s"], "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if cfg.num_experts:
        record.update(experts=cfg.num_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
                      capacity_factor=cfg.capacity_factor, heads=cfg.num_heads,
                      kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, vocab=cfg.vocab_size)
    log(f"{label} " + json.dumps(record))
    if profile and paged_profiled != paged:
        log(f"{label}: the profiler saw {paged_profiled} of the {paged} paged split kernels "
            "the device counted")
    if m.steps_completed <= 0:
        raise AssertionError("the replay completed no program step")
    if m.offloaded_pages + m.reloaded_pages <= 0:
        raise AssertionError("no page moved between the tiers")
    if captures != warm_captures:
        raise AssertionError(f"{captures - warm_captures} decode graphs captured after warmup")
    if replays != engine_steps or paged_eager != 0:
        raise AssertionError(
            f"{replays} graph replays and {paged_eager} eager paged launches for "
            f"{engine_steps} decode steps: decode did not run only through its graphs")
    if paged != cfg.num_layers * engine_steps or paged == 0:
        raise AssertionError(
            f"paged kernels the device ran {paged} != layers {cfg.num_layers} x decode "
            f"steps {engine_steps}: decode did not go through the kernel")
    if flash != cfg.num_layers * passes["prefill"] or flash == 0:
        raise AssertionError(
            f"flash kernel launches {flash} != layers {cfg.num_layers} x prefill passes "
            f"{passes['prefill']}: prefill did not go through the kernel")
    if chunked and m.prefill_chunks <= 0:
        raise AssertionError("the chunked replay ran no prefill chunk")
    produced = [t for toks in router.output_log.values() for t in toks]
    if len(produced) != m.tokens_generated or not all(
            0 <= t < cfg.vocab_size for t in produced):
        raise AssertionError("generated tokens are missing or out of the vocabulary")
    return record, engines, router


def profile_window(fn, n: int) -> tuple[dict, float]:
    """Device time by kernel name over ``n`` calls of ``fn`` (ending in a
    synchronize), and the window's host-clock length in µs."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    return device_kernel_us(prof), window_us


def host_ms(fn, n: int) -> float:
    """Host-clock milliseconds per call of ``fn`` over ``n`` calls, after
    three warm-up calls; the window ends in a synchronize."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def decode_breakdown(engine, context: int = 200, steps: int = 20):
    """Where a full-width decode step's time goes: one warmed engine with
    every slot decoding a ``context``-token request. The graphed step
    (``engine.step``: staging, one replay, the tokens read back) on the
    host clock, then a profiled window of graphed steps for the device's
    busy share and its kernel time by name; then the same step's inputs
    through the eager function the graph captured (``Engine.decode_packed``,
    the greedy tokens read back) on a clone of the pool, timed and profiled
    the same way. Runs after the main path, so its launches are not in the
    main path's count."""
    from repro_torch.serving import EngineRequest

    rng = np.random.default_rng(2)
    for i in range(engine.max_slots):
        engine.submit(EngineRequest(
            f"breakdown{i}", rng.integers(2, engine.cfg.vocab_size, context).tolist(),
            max_new_tokens=3 * steps + 20))
    step_ms = host_ms(engine.step, steps)
    kernels, window_us = profile_window(engine.step, 5)
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "batch": engine.max_slots, "context": context, "step_ms": step_ms,
        "profiled_steps": 5, "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / window_us if window_us else None,
        "device_ms_per_step": busy_us / 5e3,
        "device_share_of_step": busy_us / 5e3 / step_ms,
        "top_kernels_ms": {k[:60]: v / 1e3 for k, v in top},
        "paged_attention_ms": sum(v for k, v in kernels.items()
                                  if any(n in k for n in PAGED_KERNEL_NAMES)) / 1e3,
    }
    if DEVICE == "cuda" and not all(any(n in k for k in kernels) for n in PAGED_KERNEL_NAMES):
        raise AssertionError("the profiler saw no paged attention kernel in the replayed steps")
    # the eager function on the last replayed step's inputs
    p_used = max(len(s.table) for s in engine.slots.values())
    p_pad = -(-p_used // engine._table_bucket) * engine._table_bucket
    staged = engine._staging[p_pad][1].clone()
    clones = [t.clone() for t in engine.pool.device_tensors()]

    def eager_step():
        return engine.decode_packed(staged, p_pad, clones)[1].cpu()

    with torch.no_grad():
        eager_ms = host_ms(eager_step, steps)
        eager_kernels, eager_window_us = profile_window(eager_step, 5)
    eager_busy_us = sum(eager_kernels.values())
    out.update(
        table_pages=p_pad, eager_step_ms=eager_ms, graphed_over_eager=step_ms / eager_ms,
        eager_window_ms=eager_window_us / 1e3, eager_device_busy_ms=eager_busy_us / 1e3,
        eager_device_busy_share=eager_busy_us / eager_window_us if eager_window_us else None,
        eager_device_ms_per_step=eager_busy_us / 5e3,
        eager_device_share_of_step=eager_busy_us / 5e3 / eager_ms,
    )
    return out


def ssm_breakdown(engine, context: int = 200, steps: int = 20):
    """Where a full-width mamba2 request's time goes: a ``context``-token
    prefill (the SSD kernel in every layer) and one-token decode steps on
    the host clock (each ends in a synchronize): the graphed step (one
    replay over the engine's static state, the greedy token read back as
    ``submit`` does) and the eager function it captured
    (``Model.decode_into``) on a clone of the same state; then one
    profiled prefill and profiled windows of graphed and eager decode
    steps for the device's busy share and its kernel time by name. Runs
    after the SSM main path, so its launches are not in that path's
    count."""
    model = engine.model
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(2, engine.cfg.vocab_size, (1, context))).to(DEVICE)
    tok = torch.tensor([5], device=DEVICE)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": tokens})                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        engine._load_state(cache)
        state = {k: t.clone() for k, t in engine._state.items()}

        def graphed():
            return int(torch.argmax(engine._step_tokens(5)))

        def eager():
            return int(torch.argmax(model.decode_into(state, tok)[0]))

        step_ms = host_ms(graphed, steps)
        eager_ms = host_ms(eager, steps)
        out = {"context": context, "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
               "eager_decode_step_ms": eager_ms, "graphed_over_eager": step_ms / eager_ms}
        for name, fn, n, ms in (("prefill", lambda: model.prefill({"tokens": tokens}), 1,
                                 prefill_ms),
                                ("decode", graphed, 5, step_ms),
                                ("eager_decode", eager, 5, eager_ms)):
            kernels, window_us = profile_window(fn, n)
            busy_us = sum(kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
            out[name] = {
                "profiled_calls": n, "window_ms": window_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / window_us if window_us else None,
                "device_ms_per_call": busy_us / n / 1e3,
                "device_share_of_call": busy_us / n / 1e3 / ms,
                "ssd_kernel_ms": sum(v for k, v in kernels.items()
                                     if any(n in k for n in SSD_KERNEL_NAMES)) / 1e3,
                "top_kernels_ms": {k[:60]: v / 1e3 for k, v in top},
            }
    return out


def random_pool(engine, seed: int) -> None:
    """Fill an engine's pool with values a real context would hold, from
    a seed, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    pool = engine.pool
    for t in (pool.k, pool.v):
        if pool.quantized_device:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=DEVICE))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=DEVICE))
    if pool.quantized_device:
        for sc in (pool.k_scale, pool.v_scale):
            sc.copy_(torch.rand(sc.shape, generator=g, device=DEVICE) * 0.02 + 0.002)


def graph_parity_paged(cfg, params, formats=(("bf16", None), ("int8", 24))) -> list:
    """Each table bucket's decode graph, on a pool of each format (every
    bucket where ``formats`` names none, else that one), against the same
    step run eagerly on a clone of the pool: logits, greedy tokens and the
    pool bytes written. Fresh engines on the main path's weights, their
    pools filled from a seed, each row's length in its bucket's last four
    pages."""
    from repro_torch.serving import Engine

    rng = np.random.default_rng(8)
    cases = []
    for fmt, only in formats:
        engine = Engine(cfg, params, device=DEVICE, page_tokens=16, n_device_pages=8,
                        n_host_pages=4, max_slots=3, max_seq=384, device_format=fmt,
                        offload_format=fmt)
        random_pool(engine, seed=len(cases))
        engine.warmup()
        B, T = engine.max_slots, engine.page_tokens
        live = [p for p in range(engine.pool.k.shape[1]) if p not in engine._scratch_pages]
        for p_pad in engine.graphs.keys() if only is None else [only]:
            lengths = rng.integers((p_pad - 4) * T + 1, p_pad * T + 1, B)
            tables = rng.permutation(live)[: B * p_pad].reshape(B, p_pad)
            packed = engine._pack(rng.integers(0, cfg.vocab_size, B), lengths,
                                  tables[np.arange(B), (lengths - 1) // T], (lengths - 1) % T,
                                  tables)
            clones = [t.clone() for t in engine.pool.device_tensors()]
            with torch.no_grad():
                ran_before = paged_device_launches()
                logits, tokens = (t.clone() for t in engine._decode(p_pad, packed))
                ran = paged_device_launches() - ran_before
                want, want_tokens = engine.decode_packed(
                    torch.from_numpy(packed).to(DEVICE), p_pad, clones)
            torch.cuda.synchronize()
            cases.append({
                "case": f"{cfg.name} {fmt} pages={p_pad}",
                "max_abs_logit_diff": (logits - want).abs().max().item(),
                "tokens_equal": torch.equal(tokens, want_tokens),
                "pool_equal": all(torch.equal(a, b)
                                  for a, b in zip(engine.pool.device_tensors(), clones)),
                "layers": cfg.num_layers,
                "paged_kernels_replayed": ran,
            })
        del engine
    return cases


def graph_parity_ssm(engine) -> list:
    """The mamba2 decode graph against ``Model.decode_into`` on a clone of
    the same state, token by token from a 120-token prefill: logits,
    greedy tokens and the state."""
    model = engine.model
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(2, engine.cfg.vocab_size, (1, 120))).to(DEVICE)
    worst, tokens_equal, state_equal = 0.0, True, True
    with torch.no_grad():
        _, cache = model.prefill({"tokens": tokens})
        engine._load_state(cache)
        state = {k: t.clone() for k, t in engine._state.items()}
        for tok in rng.integers(2, engine.cfg.vocab_size, 4).tolist():
            got = engine._step_tokens(tok).clone()
            want = model.decode_into(state, torch.tensor([tok], device=DEVICE))[0]
            torch.cuda.synchronize()
            worst = max(worst, (got - want).abs().max().item())
            tokens_equal &= int(torch.argmax(got)) == int(torch.argmax(want))
            state_equal &= all(torch.equal(engine._state[k], state[k]) for k in state)
    return [{"case": "mamba2 decode", "tokens_fed": 4, "max_abs_logit_diff": worst,
             "tokens_equal": tokens_equal, "state_equal": state_equal}]


def device_kernel_us(prof, counts: dict | None = None) -> dict:
    """Device time by kernel name from a profile: device-side events only
    (the CPU ops that launched them carry the same time again as their own
    device total). ``counts``, if given, receives each name's instances."""
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return kernels


# ------------------------------------------------------------ phase 5
def serve_ssm():
    """mamba2-2.7b at full width behind MoriRouter.replay: the corpus of
    tests/test_ssm_engine.py, one device state slot, so bundles go to the
    host between a program's steps and come back."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.kernels.ssd import ops
    from repro_torch.models import Model, materialize
    from repro_torch.models.params import flatten_tree
    from repro_torch.serving import MoriRouter, SsmEngine
    from repro_torch.traces import TraceGenConfig, generate_corpus

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config("mamba2-2.7b")
    params = materialize(Model(cfg).describe(), seed=0, device=DEVICE)
    materialize_s = time.perf_counter() - t0
    engine = SsmEngine(cfg, params, device=DEVICE, n_device_states=1, n_host_states=8,
                       max_seq=256)
    router = MoriRouter([engine], scheduler="mori",
                        config=SchedulerConfig(tick_interval_s=2.0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()                      # the decode graph, before traffic
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    corpus = generate_corpus(3, seed=0, cfg=TraceGenConfig(
        min_steps=3, mean_steps=4, max_steps=4, initial_context_mean=120, max_context=240))
    counts = {"prefill": 0, "decode": 0, "eager_decode": 0, "to_host": 0, "reload": 0}
    _count_calls(engine.model, "prefill", counts, "prefill")
    _count_calls(engine, "_step_tokens", counts, "decode")
    for name in ("decode", "decode_into"):
        _count_calls(engine.model, name, counts, "eager_decode")
    _count_calls(engine, "_to_host", counts, "to_host")
    _count_calls(engine, "_reload", counts, "reload", when=lambda b: b is not None)
    ops.KERNEL.launches = 0
    engine.graphs.replays = 0
    warm_captures = engine.graphs.cache_size()
    t0 = time.perf_counter()
    m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=2)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = ops.KERNEL.launches
    bundle = next(iter({**engine.device_states, **engine.host}.values()))
    real_bytes = sum(t.numel() * t.element_size() for t in bundle.cache.values())
    record = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
        "ssm_state": cfg.ssm_state, "vocab": cfg.vocab_size, "programs": len(corpus),
        "steps_completed": m.steps_completed, "tokens_generated": m.tokens_generated,
        "cache_hit_rate": m.cache_hit_rate, "cached_tokens": m.cached_tokens,
        "prefilled_tokens": m.prefilled_tokens, "sequence_prefills": counts["prefill"],
        "decode_steps": counts["decode"], "ssm_graph_replays": engine.graphs.replays,
        "eager_decode_calls": counts["eager_decode"],
        "graph_captures": engine.graphs.cache_size(),
        "post_warmup_captures": engine.graphs.cache_size() - warm_captures,
        "bundles_offloaded": counts["to_host"],
        "bundles_reloaded": counts["reload"], "router_offloaded": m.offloaded_pages,
        "router_reloaded": m.reloaded_pages, "ssd_launches": launches,
        "bundle_bytes_reference_count": engine.bundle_bytes, "bundle_bytes_real": real_bytes,
        "setup_s": setup_s, "warmup_s": warmup_s, "replay_s": replay_s,
        "materialize_s": materialize_s, "params": sum(t.numel() for _, t in flatten_tree(params)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("serve_ssm " + json.dumps(record))
    if engine.graphs.cache_size() != warm_captures:
        raise AssertionError("the SSM decode graph was captured again during the replay")
    # a replay runs no Python, so on the card no eager decode may run at all
    if (record["ssm_graph_replays"] != counts["decode"] or counts["decode"] == 0
            or (DEVICE == "cuda" and counts["eager_decode"])):
        raise AssertionError(
            f"{record['ssm_graph_replays']} decode graph replays and {counts['eager_decode']} "
            f"eager decodes for {counts['decode']} tokens fed: decode did not run only "
            "through its graph")
    if m.steps_completed < 9:
        raise AssertionError(f"the SSM replay completed {m.steps_completed} < 9 steps")
    if counts["to_host"] <= 0 or counts["reload"] <= 0:
        raise AssertionError("no state bundle went to the host and came back")
    if launches != cfg.num_layers * counts["prefill"] or launches == 0:
        raise AssertionError(
            f"SSD kernel launches {launches} != layers {cfg.num_layers} x sequence "
            f"prefills {counts['prefill']}: prefill did not go through the kernel")
    produced = [t for toks in router.output_log.values() for t in toks]
    if len(produced) != m.tokens_generated or not all(
            0 <= t < cfg.vocab_size for t in produced):
        raise AssertionError("generated tokens are missing or out of the vocabulary")
    return record, engine


# ------------------------------------------------------------ phase 6
def draw_on_card(tree, seed: int) -> dict:
    """Random weights for the descriptor tree ``tree``, drawn on the card
    from one seeded ``torch.Generator``, leaf by leaf in sorted-key order,
    with ``materialize``'s initialisers: zeros, ones, or a normal of the
    leaf's std (its scale, else 1/sqrt(fan_in) with the reference's
    fan-in, ``shape[-2]``). Not ``materialize``'s numbers: its stream runs
    on the host, one value at a time."""
    from repro_torch.models.params import leaves

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    out: dict = {}
    for name, l in leaves(tree):
        t = torch.empty(l.shape, dtype=l.dtype, device=DEVICE)
        if l.init == "zeros" or l.scale == 0.0:
            t.zero_()
        elif l.init == "ones":
            t.fill_(1.0)
        else:
            fan_in = l.shape[-2] if len(l.shape) >= 2 else max(1, l.shape[-1])
            t.normal_(0.0, l.scale if l.scale is not None else 1.0 / math.sqrt(fan_in),
                      generator=g)
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return out


def moe_weights(cfg, host_rate: float) -> tuple[dict, dict]:
    """dbrx's weights at full width: drawn on the card when drawing them
    through ``materialize`` on the host, at the rate the mamba2 phase
    measured (``host_rate`` parameters a second), would take more than
    150 s; else through ``materialize``. Returns the tree and how it was
    drawn."""
    from repro_torch.models import Model, materialize
    from repro_torch.models.params import leaves

    tree = Model(cfg).describe()
    n = sum(math.prod(l.shape) for _, l in leaves(tree))
    host_s = n / host_rate
    t0 = time.perf_counter()
    if host_s > 150.0:
        params, how = draw_on_card(tree, seed=0), "on the card (torch.Generator, seed 0)"
    else:
        params, how = materialize(tree, seed=0, device=DEVICE), "through materialize on the host (seed 0)"
    torch.cuda.synchronize()
    info = dict(params=n, drawn=how, draw_s=time.perf_counter() - t0,
                host_estimate_s=host_s, host_rate_per_s=host_rate)
    log(f"serve_moe weights: {n / 1e9:.3f} B parameters drawn {how} in {info['draw_s']:.3f}s "
        f"(materialize on the host would take ~{host_s:.0f}s at the {host_rate / 1e6:.1f} M/s "
        "the mamba2 phase measured)")
    return params, info


def check_moe_layer(cfg, params) -> dict:
    """One full-width MoE layer (layer 0's router and experts) on a batch-3
    decode input and a 384-token prefill input, in bf16 on the card,
    against the same function evaluated in f32 on the card (the weights
    and input cast up exactly): the chosen experts and the kept slots
    equal, the output in the model band. Counts the slots dropped at the
    configuration's capacity factor."""
    from repro_torch.models import layers

    p = {k: v[0] for k, v in params["blocks"]["ffn"].items()}
    p32 = {k: v.float() for k, v in p.items()}
    rng = np.random.default_rng(11)
    out = {}
    with torch.no_grad():
        for name, (B, S) in (("decode", (3, 1)), ("prefill", (1, 384))):
            x = randn_dev(rng, (B, S, cfg.d_model), torch.bfloat16)
            g = min(4096, S)
            y, _ = layers.apply_moe(p, x, cfg)
            y32, _ = layers.apply_moe(p32, x.float(), cfg)
            route = layers.moe_route(p, x.reshape(-1, g, cfg.d_model), cfg)
            route32 = layers.moe_route(p32, x.float().reshape(-1, g, cfg.d_model), cfg)
            torch.cuda.synchronize()
            diff = (y.float() - y32).abs()
            rec = dict(
                B=B, S=S, group=g, capacity=layers.moe_capacity(cfg, g),
                entries=B * S * cfg.top_k, dropped_slots=int((~route[4]).sum()),
                experts_equal=torch.equal(route[2], route32[2]),
                kept_equal=torch.equal(route[4], route32[4]),
                finite=bool(torch.isfinite(y).all()), max_abs_err=diff.max().item(),
                max_abs_f32=y32.abs().max().item(),
                in_band=bool((diff <= MODEL_ATOL + MODEL_RTOL * y32.abs()).all()))
            out[name] = rec
            if not (rec["experts_equal"] and rec["kept_equal"] and rec["finite"]
                    and rec["in_band"]):
                raise AssertionError(f"the MoE layer in bf16 disagrees with f32 ({name}): {rec}")
    del p32
    if out["prefill"]["dropped_slots"] == 0:
        log(f"moe layer: no slot was dropped in the 384-token prefill at capacity factor "
            f"{cfg.capacity_factor} on these random weights")
    return out


def moe_breakdown(engine) -> dict:
    """Where a full-width dbrx decode step's time goes: ``decode_breakdown``
    (graphed and eager, device shares), then the MoE layers alone at the
    step's shape (``max_slots`` rows of one token, the engine's own layer
    weights), profiled, against the bytes of expert weights they must read
    (every expert runs on every group's slots, so a step reads them all)."""
    from repro_torch.models import layers

    cfg = engine.cfg
    out = decode_breakdown(engine)
    x = randn_dev(np.random.default_rng(12), (engine.max_slots, 1, cfg.d_model),
                  torch.bfloat16)
    ffns = [p["ffn"] for p in engine.model._layers]

    def moe_layers():
        with torch.no_grad():
            for p in ffns:
                layers.apply_moe(p, x, cfg)

    kernels, window_us = profile_window(moe_layers, 5)
    moe_ms = sum(kernels.values()) / 5e3
    expert_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff * 2
    b = bound(expert_bytes * cfg.num_layers, 0, "bfloat16")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out["moe"] = dict(
        layers=cfg.num_layers, expert_bytes_per_layer=expert_bytes,
        device_ms_per_step=moe_ms, bound_ms_per_step=b["bound_ms"],
        bound_over_device=b["bound_ms"] / moe_ms if moe_ms else None,
        share_of_step_device_ms=moe_ms / out["device_ms_per_step"]
        if out["device_ms_per_step"] else None,
        host_ms_per_step=host_ms(moe_layers, 10),
        top_kernels_ms={k[:60]: v / 5e3 for k, v in top})
    return out


def serve_moe(args, host_rate: float):
    """dbrx-132b at full width, cut to ``MOE_LAYERS`` layers, behind
    MoriRouter.replay as the qwen replay is served; then the full-width
    MoE layer check, every bucket's decode graph against its eager step,
    and the decode step's breakdown."""
    from repro_torch.configs import get_config

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    params, draw = moe_weights(cfg, host_rate)
    record, engines, _ = replay_paged(args, chunked=False, cfg=cfg, params=params,
                                      label="serve_moe")
    record["weights"] = draw
    layer = check_moe_layer(cfg, params)
    log("moe layer " + json.dumps(layer))
    parity = graph_parity_paged(cfg, params, formats=(("bf16", None),))
    log("moe breakdown " + json.dumps(moe_breakdown(engines[0])))
    return record, parity


# ------------------------------------------------------------ phase 7
#: serve_replicas: replica 1 fails at the first virtual time and recovers
#: at the second (seconds on the router's clock), mid-replay
REPLICA_FAULT = (20.0, 80.0)
#: serve_replicas: the NVMe tier's budget, in int8 host pages a replica
SSD_PAGES = 40
#: the logits kept of each sampled token when comparing two replays
TOP_K = 8


def check_dense_slot_view() -> float:
    """The dense-slot decode attention at the serving shape (3 slots of
    max_seq 384, MHA 16x64, read as 16-token pages), the kernel on the
    card against the reference's masked softmax in plain PyTorch on the
    same inputs; for the lengths of a full, a ragged and a free slot."""
    from repro_torch.models.layers import decode_attention

    B, H, KH, D, T, P = MAIN_SHAPE
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for shape in ((B, H, D), (B, P * T, KH, D), (B, P * T, KH, D)))
    lens = torch.tensor([P * T, 250, 1], dtype=torch.int32)
    err = 0.0
    for window in (None, 100):
        got = decode_attention(q.to(DEVICE), k.to(DEVICE), v.to(DEVICE), lengths=lens.to(DEVICE),
                               window=window, page_tokens=T)
        want = decode_attention(q, k, v, lengths=lens, window=window, page_tokens=T)
        torch.cuda.synchronize()
        err = max(err, check_close(f"dense slots B={B} H={H} S={P * T} D={D} T={T} "
                                   f"window={window}", got.cpu(), want, ATOL["bfloat16"]))
    return err


def record_top_logits(engines, tops: dict) -> None:
    """Wrap each engine so that every token it samples (a prefill's, and
    each advancing row's at a decode step) appends that pass's ``TOP_K``
    largest logits and their token ids to ``tops[program id]``: the order
    in which the router logs the program's tokens."""
    def keep(pid, logits):
        vals, ids = torch.topk(logits.float(), TOP_K)
        tops.setdefault(pid, []).append((vals.tolist(), ids.tolist()))

    for e in engines:
        last = {}

        def prefill(*a, _f=e.model.prefill, _last=last, **kw):
            logits, cache = _f(*a, **kw)
            _last["prefill"] = logits[0]
            return logits, cache

        def decode(key, packed, _f=e._decode, _last=last):
            out = _f(key, packed)
            _last["decode"] = out[0]
            return out

        def submit(req, _f=e.submit, _last=last):
            sid = _f(req)
            keep(req.program_id, _last.pop("prefill"))
            return sid

        def step(active=None, _f=e.step, _e=e, _last=last):
            pids = {sid: slot.request.program_id for sid, slot in _e.slots.items()}
            rows = [sid for sid in (pids if active is None else active) if sid in pids]
            done = _f(active)
            if "decode" in _last:
                logits = _last.pop("decode")
                for sid in rows:
                    keep(pids[sid], logits[sid])
            return done

        e.model.prefill, e._decode, e.submit, e.step = prefill, decode, submit, step


def compare_logs(got: dict, want: dict, tops: dict) -> dict:
    """``got``'s output log against ``want``'s, program by program. Where
    they part, the first differing token must be a near tie in ``got``'s
    run: ``want``'s token among its top logits, within the model band
    (MODEL_ATOL + MODEL_RTOL·|top logit|) of the largest."""
    if set(got) != set(want):
        raise AssertionError("the two replays served different programs")
    firsts = []
    for pid in sorted(got):
        a, b = got[pid], want[pid]
        if len(a) != len(b) or len(tops.get(pid, [])) != len(a):
            raise AssertionError(f"{pid}: {len(a)} tokens against {len(b)}, "
                                 f"{len(tops.get(pid, []))} sampled")
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        vals, ids = tops[pid][i]
        band = MODEL_ATOL + MODEL_RTOL * abs(vals[0])
        gap = vals[0] - vals[ids.index(b[i])] if b[i] in ids else math.inf
        firsts.append(dict(program=pid, index=i, token=a[i], other_token=b[i],
                           logit_gap=gap, band=band))
        if gap > band:
            raise AssertionError(f"{pid} parts from the other replay at token {i} "
                                 f"by a logit gap {gap} beyond the band {band}")
    return dict(output_log_equal=not firsts, programs_differing=len(firsts),
                first_differences=firsts)


def serve_dense_slots(args, cfg, params, serve_log: dict) -> dict:
    """Two warmed ``Engine(dense_slots=True)`` replicas behind
    ``MoriRouter.replay`` with the launcher's pools, corpus and scheduler
    (monolithic prefill): one decode graph an engine, captured in warmup,
    replayed at every step; paged kernels (over the slots seen as pages)
    = layers x decode steps on the device; the output log against phase
    4's ``serve`` log."""
    tops: dict = {}
    record, engines, router = replay_paged(
        args, chunked=False, cfg=cfg, params=params, label="serve_dense_slots",
        engine_kw=dict(dense_slots=True), profile=False,
        watch=lambda engines: record_top_logits(engines, tops))
    if record["graph_captures"] != len(engines) or record["graph_buckets"] != ["dense"]:
        raise AssertionError(f"dense-slot engines captured {record['graph_buckets']} "
                             f"{record['graph_captures']} times, not one graph each")
    out = compare_logs(router.output_log, serve_log, tops)
    m = router.metrics
    out.update(steps_completed=m.steps_completed, offloaded_pages=m.offloaded_pages,
               reloaded_pages=m.reloaded_pages, decode_reserve_pages=engines[0].decode_reserve_pages)
    log("serve_dense_slots against serve " + json.dumps(out))
    record.update(out)
    return record


def serve_replicas(args, cfg, params) -> dict:
    """Two warmed paged replicas with pressure migration on, int8 offload,
    an NVMe tier and the page-lifetime sanitizer armed, replica 1 failing
    mid-replay and recovering (``REPLICA_FAULT``): programs migrate, the
    drain runs once, every program completes every step, offloads are
    billed at the int8 page size, and the sanitizer stays quiet."""
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.kernels import kv_quant
    from repro_torch.launch import serve
    from repro_torch.sim import FaultPlan

    int8_page = kv_quant.page_wire_bytes(cfg.num_layers, 16, cfg.num_kv_heads, cfg.head_dim,
                                         "int8")
    os.environ["REPRO_KVSAN"] = "1"
    try:
        record, engines, router = replay_paged(
            args, chunked=False, cfg=cfg, params=params, label="serve_replicas",
            engine_kw=dict(offload_format="int8"), profile=False,
            router_kw=dict(config=SchedulerConfig(tick_interval_s=1.0, migrate_on_pressure=True),
                           ssd_capacity_bytes=SSD_PAGES * int8_page),
            replay_kw=dict(faults=[FaultPlan(replica=1, fail_at=REPLICA_FAULT[0],
                                             recover_at=REPLICA_FAULT[1])]))
    finally:
        os.environ.pop("REPRO_KVSAN")
    m = router.metrics
    corpus = serve.corpus_for(args)
    want_steps = {t.program_id: len(t.steps) for t in corpus}
    out = dict(
        fault=dict(replica=1, fail_at=REPLICA_FAULT[0], recover_at=REPLICA_FAULT[1]),
        migrations=m.migrations, migrated_pages=m.migrated_pages, drain_events=m.drain_events,
        requeued_slots=m.requeued_slots, cancelled_pages=m.cancelled_pages,
        nvme_reloaded_pages=m.nvme_reloaded_pages, offload_bytes=m.offload_bytes,
        reload_bytes=m.reload_bytes, host_page_bytes=engines[0].pool.host_page_bytes,
        int8_page_bytes=int8_page, steps_expected=sum(want_steps.values()),
        kvsan_armed=all(e.pool._san is not None for e in engines),
        checker_ran=router._checker is not None, ledger_open=len(router.sched.ledger),
    )
    log("serve_replicas checks " + json.dumps(out))
    record.update(out)
    lost = {pid: len(router.output_log.get(pid, [])) for pid, n in want_steps.items()
            if len(router.output_log.get(pid, [])) != n * args.max_new_tokens}
    if m.steps_completed != out["steps_expected"] or lost:
        raise AssertionError(f"tokens lost: {m.steps_completed} of {out['steps_expected']} "
                             f"steps completed; short programs {lost}")
    if m.migrations <= 0 or m.migrated_pages <= 0:
        raise AssertionError("no program migrated between the replicas")
    if m.drain_events != 1:
        raise AssertionError(f"{m.drain_events} drain events, not 1")
    if engines[0].pool.host_page_bytes != int8_page or m.offload_bytes != (
            m.offloaded_pages * int8_page):
        raise AssertionError("offloads are not billed at the int8 page size")
    if not (out["kvsan_armed"] and out["checker_ran"]) or out["ledger_open"]:
        raise AssertionError("the sanitizer did not run, or left a transfer open")
    return record


# ------------------------------------------------------------ phase 8
#: gemma2-9b at full width and depth: a 4600-token prompt (it wraps the
#: 4096-slot local ring) and a 1000-token one, global slots of 4624
GEMMA2_ARCH, GEMMA2_PROMPTS, GEMMA2_MAX_SEQ = "gemma2-9b", (4600, 1000), 4624
#: zamba2-2.7b at full width and depth: 9 groups of 6 mamba layers and the
#: shared block, prompts of 384 and 200 tokens, shared slots of 400
ZAMBA2_ARCH, ZAMBA2_PROMPTS, ZAMBA2_MAX_SEQ = "zamba2-2.7b", (384, 200), 400
#: whisper-medium at full width and depth: 24 encoder and 24 decoder
#: layers, frames of 1500 x 1024 a row (the stub of the convolutional front
#: end), prompts of 64 and 24 tokens, self-attention slots of 448
WHISPER_ARCH, WHISPER_PROMPTS, WHISPER_MAX_SEQ = "whisper-medium", (64, 24), 448
#: internvl2-26b at full width and depth: 48 layers, 256 image embeddings a
#: row (the stub of the InternViT front end) before prompts of 600 and 200
#: tokens, slots of 880 = 55 pages of 16 (the longer row reaches 872)
INTERNVL2_ARCH, INTERNVL2_PROMPTS, INTERNVL2_MAX_SEQ = "internvl2-26b", (600, 200), 880
#: greedy decode steps of each phase-8 model
MODEL_STEPS = 16


def card_model(arch: str, seed: int):
    """``arch`` at full width and depth, its weights drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.params import leaves

    cfg = get_config(arch)
    t0 = time.perf_counter()
    tree = Model(cfg).describe()
    params = draw_on_card(tree, seed)
    torch.cuda.synchronize()
    info = dict(arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
                params=sum(math.prod(l.shape) for _, l in leaves(tree)),
                draw_s=time.perf_counter() - t0)
    return cfg, Model(cfg, params), info


def seeded_prompts(seed: int, lengths, vocab: int) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, vocab, n).astype(np.int64)).to(DEVICE)
            for n in lengths]


def synced_ms(fn):
    """``fn()`` and its host-clock milliseconds, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def zeros_tree(tree) -> dict:
    """Zero tensors on the card for a descriptor tree."""
    from repro_torch.models.params import Leaf

    return {k: zeros_tree(v) if not isinstance(v, Leaf)
            else torch.zeros(v.shape, dtype=v.dtype, device=DEVICE) for k, v in tree.items()}


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def greedy_decode(model, cache, first, lengths, feed=None):
    """``MODEL_STEPS`` eager decode steps into ``cache`` from the tokens
    ``first`` at context ``lengths`` (prompt lengths), each step feeding
    its argmax, or ``feed[i]`` where given (teacher forcing). Returns the
    fed tokens [steps, B], every step's logits [steps, B, V] and the host
    milliseconds a step."""
    tok, fed, logits = first, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MODEL_STEPS):
        tok = tok if feed is None else feed[i]
        fed.append(tok)
        out = model.decode_into(cache, tok, lengths + i + 1)
        logits.append(out)
        tok = torch.argmax(out, -1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MODEL_STEPS
    return torch.stack(fed), torch.stack(logits), step_ms


def near_tie(logits, want: int, got: int) -> float:
    """How far ``got`` falls short of ``want``, the argmax, in ``logits``,
    against the model band at that logit: <= 0 is a near tie."""
    top = logits[want].item()
    return (top - logits[got].item()) - (MODEL_ATOL + MODEL_RTOL * abs(top))


def compare_greedy(what: str, logits, want_logits) -> dict:
    """Two runs' logits [steps, B, V] on the same fed tokens: the largest
    difference, and each step's top-1 equal or a near tie in ``want``."""
    diff = (logits - want_logits).abs().max().item()
    parted = []
    for i, b in zip(*torch.nonzero(logits.argmax(-1) != want_logits.argmax(-1),
                                   as_tuple=True)):
        got, want = int(logits[i, b].argmax()), int(want_logits[i, b].argmax())
        parted.append(dict(step=int(i), row=int(b), tokens=[got, want],
                           excess_over_band=near_tie(want_logits[i, b], want, got)))
    rec = dict(max_abs_logit_diff=diff, top1_parted=parted)
    if not math.isfinite(diff) or any(p["excess_over_band"] > 0 for p in parted):
        raise AssertionError(f"{what}: top-1 parts beyond a near tie: {rec}")
    return rec


def against_prefill(model, prompts, fed, last_logits, rows=None) -> dict:
    """The last decode step's logits against a prefill of each row's
    prompt and its fed tokens, one row at a time; ``rows[b]`` holds what
    else row ``b``'s batch takes (frames, image embeddings)."""
    want = []
    for b, prompt in enumerate(prompts):
        seq = torch.cat([prompt, fed[:, b]])[None]
        want.append(model.prefill({"tokens": seq, **(rows[b] if rows else {})})[0][0])
    return compare_greedy("decode vs prefill of the longer sequence", last_logits[None],
                          torch.stack(want)[None])


def decode_device_ms(model, cache, tok, lengths) -> dict:
    """The last decode step again (it rewrites the same slots), profiled:
    device time a step and its share of the step's host clock."""
    kernels, window_us = profile_window(lambda: model.decode_into(cache, tok, lengths), 3)
    busy_us = sum(kernels.values())
    return dict(device_ms_per_step=busy_us / 3e3,
                device_share_of_window=busy_us / window_us if window_us else None,
                paged_attention_ms_per_step=sum(
                    v for k, v in kernels.items()
                    if any(n in k for n in PAGED_KERNEL_NAMES)) / 3e3)


def model_gemma2() -> dict:
    """gemma2-9b at full width and depth: the two prompts prefilled one at
    a time (flash in all 42 layers, windowed softcapped attention in the
    21 local ones), their KV put into global slots of ``GEMMA2_MAX_SEQ``
    and into a local ring of ``sliding_window`` slots (position p in slot
    p % 4096: the 4600-token prompt wraps it), then ``MODEL_STEPS`` greedy
    steps over the ring (the paged kernel in every layer, the local ones
    over the ring's 256 pages); the same tokens again over full-size local
    slots; the last step against a prefill of the longer sequence."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.cuda.reset_peak_memory_stats()
    cfg, model, info = card_model(GEMMA2_ARCH, seed=0)
    W, S = cfg.sliding_window, GEMMA2_MAX_SEQ
    prompts = seeded_prompts(21, GEMMA2_PROMPTS, cfg.vocab_size)
    full = zeros_tree(model.describe_cache(len(prompts), S))
    ring_local = zeros_tree(model.describe_cache(len(prompts), W))["local"]
    flash_ops.KERNEL.launches = 0
    first, prefill_ms = [], []
    for b, prompt in enumerate(prompts):
        (logits, pre), ms = synced_ms(lambda: model.prefill({"tokens": prompt[None]}))
        n = prompt.numel()
        prefill_ms.append(ms)
        for kind in ("local", "global"):
            for name in ("k", "v"):
                full[kind][name][:, b, :n] = pre[kind][name][:, 0]
        pos = torch.arange(max(0, n - W), n, device=DEVICE)
        for name in ("k", "v"):
            ring_local[name][:, b, pos % W] = pre["local"][name][:, 0, pos]
        first.append(torch.argmax(logits[0]))
        del pre
    flash = flash_ops.KERNEL.launches
    first = torch.stack(first)
    lengths = torch.tensor(GEMMA2_PROMPTS, dtype=torch.int32, device=DEVICE)
    # each run decodes into global slots of its own
    ring = {"local": ring_local, "global": {n: t.clone() for n, t in full["global"].items()}}

    paged_ops.KERNEL.launches = 0
    before = paged_device_launches()
    fed, ring_logits, ring_step_ms = greedy_decode(model, ring, first, lengths)
    paged_ring = paged_device_launches() - before
    before = paged_device_launches()
    _, full_logits, full_step_ms = greedy_decode(model, full, first, lengths, feed=fed)
    paged_full = paged_device_launches() - before
    paged_eager = paged_ops.KERNEL.launches
    ring_vs_full = compare_greedy("gemma2 ring vs full-cache decode", ring_logits, full_logits)
    vs_prefill = against_prefill(model, prompts, fed, ring_logits[-1])
    device = decode_device_ms(model, ring, fed[-1], lengths + MODEL_STEPS)
    record = dict(
        info, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, window=W,
        prompts=list(GEMMA2_PROMPTS), max_seq=S, decode_steps=MODEL_STEPS,
        flash_launches=flash, prefills=len(prompts), paged_kernel_launches_ring=paged_ring,
        paged_kernel_launches_full=paged_full, paged_wrapper_calls=paged_eager,
        prefill_ms=prefill_ms, ring_step_ms=ring_step_ms, full_step_ms=full_step_ms,
        **device, local_cache_bytes_ring=tree_bytes(ring["local"]),
        local_cache_bytes_full=tree_bytes(full["local"]), ring_vs_full=ring_vs_full,
        decode_vs_prefill=vs_prefill, tokens=fed.T.tolist(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("gemma2 " + json.dumps(record))
    if flash != cfg.num_layers * len(prompts):
        raise AssertionError(f"flash launches {flash} != layers {cfg.num_layers} x prefills "
                             f"{len(prompts)}: prefill did not go through the kernel")
    for what, n in (("ring", paged_ring), ("full-cache", paged_full)):
        if n != cfg.num_layers * MODEL_STEPS:
            raise AssertionError(f"{what} decode: paged kernels the device ran {n} != layers "
                                 f"{cfg.num_layers} x steps {MODEL_STEPS}")
    if not torch.isfinite(ring_logits).all():
        raise AssertionError("non-finite gemma2 logits")
    return record


def model_zamba2() -> dict:
    """zamba2-2.7b at full width and depth: the two prompts prefilled one
    at a time (the SSD scan in all 54 mamba layers, flash in the 9 shared
    block calls), the states and shared KV gathered into one batch-2 cache
    with shared slots of ``ZAMBA2_MAX_SEQ``, ``MODEL_STEPS`` greedy steps
    (the paged kernel at D = 160 in each shared block call), the last step
    against a prefill of the longer sequence."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    torch.cuda.reset_peak_memory_stats()
    cfg, model, info = card_model(ZAMBA2_ARCH, seed=0)
    groups = cfg.num_layers // cfg.shared_attn_period
    prompts = seeded_prompts(22, ZAMBA2_PROMPTS, cfg.vocab_size)
    cache = zeros_tree(model.describe_cache(len(prompts), ZAMBA2_MAX_SEQ))
    flash_ops.KERNEL.launches = 0
    ssd_ops.KERNEL.launches = 0
    routes = dict(ssd_ops.KERNEL.routes)
    first, prefill_ms = [], []
    for b, prompt in enumerate(prompts):
        (logits, pre), ms = synced_ms(lambda: model.prefill({"tokens": prompt[None]}))
        prefill_ms.append(ms)
        cache["ssm"][:, :, b] = pre["ssm"][:, :, 0]
        cache["conv"][:, :, b] = pre["conv"][:, :, 0]
        for name in ("shared_k", "shared_v"):
            cache[name][:, b, :prompt.numel()] = pre[name][:, 0]
        first.append(torch.argmax(logits[0]))
        del pre
    flash, ssd = flash_ops.KERNEL.launches, ssd_ops.KERNEL.launches
    ssd_routes = {k: v - routes[k] for k, v in ssd_ops.KERNEL.routes.items()}
    lengths = torch.tensor(ZAMBA2_PROMPTS, dtype=torch.int32, device=DEVICE)

    paged_ops.KERNEL.launches = 0
    before = paged_device_launches()
    fed, logits, step_ms = greedy_decode(model, cache, torch.stack(first), lengths)
    paged = paged_device_launches() - before
    paged_eager = paged_ops.KERNEL.launches
    vs_prefill = against_prefill(model, prompts, fed, logits[-1])
    device = decode_device_ms(model, cache, fed[-1], lengths + MODEL_STEPS)
    record = dict(
        info, groups=groups, period=cfg.shared_attn_period, ssm_state=cfg.ssm_state,
        shared_heads=cfg.num_heads, shared_head_dim=cfg.hybrid_head_dim,
        prompts=list(ZAMBA2_PROMPTS), max_seq=ZAMBA2_MAX_SEQ, decode_steps=MODEL_STEPS,
        ssd_launches=ssd, ssd_routes=ssd_routes, flash_launches=flash, prefills=len(prompts),
        paged_kernel_launches=paged, paged_wrapper_calls=paged_eager, prefill_ms=prefill_ms,
        step_ms=step_ms, **device, cache_bytes=tree_bytes(cache), decode_vs_prefill=vs_prefill,
        tokens=fed.T.tolist(), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("zamba2 " + json.dumps(record))
    n = len(prompts)
    if ssd != cfg.num_layers * n or ssd_routes.get("tensor_core") != ssd:
        raise AssertionError(f"SSD launches {ssd} (routes {ssd_routes}) != layers "
                             f"{cfg.num_layers} x prefills {n}, all on the tensor cores")
    if flash != groups * n:
        raise AssertionError(f"flash launches {flash} != groups {groups} x prefills {n}")
    if paged != groups * MODEL_STEPS:
        raise AssertionError(f"paged kernels the device ran {paged} != groups {groups} x "
                             f"steps {MODEL_STEPS}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite zamba2 logits")
    return record


def model_whisper() -> dict:
    """whisper-medium at full width and depth: the two prompts prefilled
    one at a time over their own frames (flash in all 24 encoder layers,
    and for self- and cross-attention in all 24 decoder layers), their self
    KV put into slots of ``WHISPER_MAX_SEQ`` and their cross KV into the
    1500-position cross caches, then ``MODEL_STEPS`` greedy steps at batch
    2 (the paged kernel twice a decoder layer: over the self slots in
    16-token pages and over the cross cache in 30-token pages); the last
    step against a prefill of the longer sequence."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.models.layers import dividing_page_tokens

    torch.cuda.reset_peak_memory_stats()
    cfg, model, info = card_model(WHISPER_ARCH, seed=0)
    prompts = seeded_prompts(23, WHISPER_PROMPTS, cfg.vocab_size)
    g = torch.Generator(device=DEVICE).manual_seed(24)
    frames = torch.randn((len(prompts), cfg.encoder_seq, cfg.d_model), generator=g,
                         device=DEVICE)
    rows = [{"frames": frames[b:b + 1]} for b in range(len(prompts))]
    cache = zeros_tree(model.describe_cache(len(prompts), WHISPER_MAX_SEQ))
    flash_ops.KERNEL.launches = 0
    first, prefill_ms = [], []
    for b, prompt in enumerate(prompts):
        (logits, pre), ms = synced_ms(lambda: model.prefill({"tokens": prompt[None], **rows[b]}))
        prefill_ms.append(ms)
        for name in ("k", "v"):
            cache[name][:, b, :prompt.numel()] = pre[name][:, 0]
        for name in ("ck", "cv"):
            cache[name][:, b] = pre[name][:, 0]
        first.append(torch.argmax(logits[0]))
        del pre
    flash = flash_ops.KERNEL.launches
    lengths = torch.tensor(WHISPER_PROMPTS, dtype=torch.int32, device=DEVICE)

    paged_ops.KERNEL.launches = 0
    before = paged_device_launches()
    fed, logits, step_ms = greedy_decode(model, cache, torch.stack(first), lengths)
    paged = paged_device_launches() - before
    paged_eager = paged_ops.KERNEL.launches
    vs_prefill = against_prefill(model, prompts, fed, logits[-1], rows)
    device = decode_device_ms(model, cache, fed[-1], lengths + MODEL_STEPS)
    L, n = cfg.num_layers, len(prompts)
    cross_bytes = tree_bytes({k: cache[k] for k in ("ck", "cv")})
    record = dict(
        info, encoder_layers=cfg.encoder_layers, encoder_seq=cfg.encoder_seq,
        heads=cfg.num_heads, head_dim=cfg.head_dim, prompts=list(WHISPER_PROMPTS),
        max_seq=WHISPER_MAX_SEQ, cross_page_tokens=dividing_page_tokens(cfg.encoder_seq),
        decode_steps=MODEL_STEPS, flash_launches=flash, prefills=n,
        paged_kernel_launches=paged, paged_wrapper_calls=paged_eager, prefill_ms=prefill_ms,
        step_ms=step_ms, **device, cross_cache_bytes=cross_bytes,
        self_cache_bytes=tree_bytes({k: cache[k] for k in ("k", "v")}),
        decode_vs_prefill=vs_prefill, tokens=fed.T.tolist(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("whisper " + json.dumps(record))
    if flash != (cfg.encoder_layers + 2 * L) * n:
        raise AssertionError(f"flash launches {flash} != (encoder {cfg.encoder_layers} + "
                             f"self and cross {2 * L}) x prefills {n}")
    if paged != 2 * L * MODEL_STEPS:
        raise AssertionError(f"paged kernels the device ran {paged} != self and cross "
                             f"{2 * L} x steps {MODEL_STEPS}")
    # the cross caches are bf16 on the card
    want = 2 * L * n * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim * 2  # lint: kv008-ok
    if cross_bytes != want:
        raise AssertionError(f"cross caches of {cross_bytes} B")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite whisper logits")
    return record


def paged_greedy(model, k_pages, v_pages, tables, fed, lengths, page_tokens: int):
    """``MODEL_STEPS`` eager ``decode_paged`` steps feeding ``fed`` [steps,
    B] from context ``lengths``, each token's KV appended at its tail page.
    Returns every step's logits [steps, B, V] and the host ms a step."""
    rows = torch.arange(tables.shape[0], device=DEVICE)
    logits = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MODEL_STEPS):
        lens = lengths + i + 1
        pos = (lens - 1).long()
        logits.append(model.decode_paged(k_pages, v_pages, fed[i], lens, tables,
                                         tables[rows, pos // page_tokens],
                                         pos % page_tokens))
    torch.cuda.synchronize()
    return torch.stack(logits), (time.perf_counter() - t0) * 1e3 / MODEL_STEPS


def model_internvl2() -> dict:
    """internvl2-26b at full width and depth: 256 image embeddings before
    each of the two prompts, prefilled one at a time (flash in all 48
    layers); their KV put into slots of ``INTERNVL2_MAX_SEQ`` and into a
    pool of 16-token pages behind a permuted block table; ``MODEL_STEPS``
    greedy steps over the slots (the paged kernel over the slots as pages,
    ``lengths`` counting the image tokens), the same tokens again through
    ``decode_paged`` over the pool; the last step against a prefill of the
    longer sequence."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.cuda.reset_peak_memory_stats()
    cfg, model, info = card_model(INTERNVL2_ARCH, seed=0)
    L, KH, HD, T = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 16
    n_img, n = cfg.num_image_tokens, len(INTERNVL2_PROMPTS)
    prompts = seeded_prompts(25, INTERNVL2_PROMPTS, cfg.vocab_size)
    # image embeddings at the token embeddings' scale (their std, 0.02)
    g = torch.Generator(device=DEVICE).manual_seed(26)
    images = 0.02 * torch.randn((n, n_img, cfg.d_model), generator=g, device=DEVICE)
    rows = [{"image_embeds": images[b:b + 1]} for b in range(n)]
    cache = zeros_tree(model.describe_cache(n, INTERNVL2_MAX_SEQ))
    P = INTERNVL2_MAX_SEQ // T
    pool = {name: torch.zeros((L, n * P, T, KH, HD), dtype=torch.bfloat16, device=DEVICE)
            for name in ("k", "v")}
    perm = np.random.default_rng(27).permutation(n * P).reshape(n, P).astype(np.int32)
    tables = torch.from_numpy(perm).to(DEVICE)
    flash_ops.KERNEL.launches = 0
    first, prefill_ms = [], []
    for b, prompt in enumerate(prompts):
        (logits, pre), ms = synced_ms(lambda: model.prefill({"tokens": prompt[None], **rows[b]}))
        prefill_ms.append(ms)
        ctx = n_img + prompt.numel()
        for name in ("k", "v"):
            cache[name][:, b, :ctx] = pre[name][:, 0]
            flat = cache[name][:, b].reshape(L, P, T, KH, HD)
            pool[name][:, tables[b].long()] = flat
        first.append(torch.argmax(logits[0]))
        del pre
    flash = flash_ops.KERNEL.launches
    lengths = torch.tensor([n_img + p for p in INTERNVL2_PROMPTS], dtype=torch.int32,
                           device=DEVICE)

    paged_ops.KERNEL.launches = 0
    before = paged_device_launches()
    fed, slot_logits, step_ms = greedy_decode(model, cache, torch.stack(first), lengths)
    paged_slots = paged_device_launches() - before
    before = paged_device_launches()
    pool_logits, paged_step_ms = paged_greedy(model, pool["k"], pool["v"], tables, fed,
                                              lengths, T)
    paged_pool = paged_device_launches() - before
    paged_eager = paged_ops.KERNEL.launches
    pool_vs_slots = compare_greedy("internvl2 decode_paged vs slot decode", pool_logits,
                                   slot_logits)
    vs_prefill = against_prefill(model, prompts, fed, slot_logits[-1], rows)
    device = decode_device_ms(model, cache, fed[-1], lengths + MODEL_STEPS)
    record = dict(
        info, heads=cfg.num_heads, kv_heads=KH, head_dim=HD, image_tokens=n_img,
        prompts=list(INTERNVL2_PROMPTS), contexts=lengths.tolist(), max_seq=INTERNVL2_MAX_SEQ,
        decode_steps=MODEL_STEPS, flash_launches=flash, prefills=n,
        paged_kernel_launches_slots=paged_slots, paged_kernel_launches_pool=paged_pool,
        paged_wrapper_calls=paged_eager, prefill_ms=prefill_ms, step_ms=step_ms,
        paged_step_ms=paged_step_ms, **device, cache_bytes=tree_bytes(cache),
        pool_vs_slots=pool_vs_slots, decode_vs_prefill=vs_prefill, tokens=fed.T.tolist(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("internvl2 " + json.dumps(record))
    if flash != L * n:
        raise AssertionError(f"flash launches {flash} != layers {L} x prefills {n}")
    for what, got in (("slot", paged_slots), ("decode_paged", paged_pool)):
        if got != L * MODEL_STEPS:
            raise AssertionError(f"{what} decode: paged kernels the device ran {got} != layers "
                                 f"{L} x steps {MODEL_STEPS}")
    if not torch.isfinite(slot_logits).all():
        raise AssertionError("non-finite internvl2 logits")
    return record


# ------------------------------------------------------------ phase 9: training
#: the flash backward kernel's cases, [B, S, H, D]: qwen1.5-0.5b's training
#: shape (a microbatch of 4 rows of 1024 tokens); a gemma2-like layer (GQA
#: 2:1 at D = 256, window and softcap, q scaled by 8 so the cap binds, as
#: GEMMA2_DECODE); zamba2's D = 160; whisper's cross-attention (64 queries
#: over the 1500 encoder positions, bidirectional); ragged tails (1000
#: rows, which the tensor-core passes' copies zero-fill past the end) at
#: GQA 4:1 and D = 128. Each case's band must reject the plain gradient
#: without the softcap or the window, or with the other of
#: causal/bidirectional
FLASH_BWD_CASES = {
    "qwen_train": dict(B=4, Sq=1024, Skv=1024, H=16, KH=16, D=64, causal=True),
    "gemma2_like": dict(B=1, Sq=640, Skv=640, H=16, KH=8, D=256, causal=True, window=256,
                        cap=50.0, q_scale=8.0),
    "d160": dict(B=1, Sq=384, Skv=384, H=32, KH=32, D=160, causal=True),
    "whisper_cross": dict(B=2, Sq=64, Skv=1500, H=16, KH=16, D=64, causal=False),
    "ragged_gqa_d128": dict(B=1, Sq=1000, Skv=1000, H=32, KH=8, D=128, causal=True),
}
#: the backward's kernels, three a call: Di = rowsum(dO ∘ O), then dK/dV
#: and dQ on the tensor cores (``_mma_``) or the CUDA cores
FLASH_BWD_KERNELS = ("flash_bwd_dot_kernel", "flash_bwd_dkdv_mma_kernel",
                     "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
#: the full-width training run: the launcher's flags (seed-0 weights drawn
#: on the card, no checkpoint: one of qwen's state would write ~7.4 GB)
TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--global-batch", "8", "--seq-len", "1024",
              "--microbatches", "2", "--steps", "6", "--lr", "3e-4", "--ckpt-every", "0"]
#: the SSD backward kernel's cases, (b, s, h, p, n, chunk, fused): the
#: reference's shapes (tests/test_kernels.py); mamba2's training shape (a
#: microbatch of 2 x 1024 tokens, 80 heads of 64, state 128, x, B and C
#: slices of one fused [2, 1024, 5376] tensor); a ragged S = 1000; one
#: chunk; zamba2's state of 64. Each in f32 and bf16, with and without a
#: final-state cotangent
SSD_BWD_CASES = {
    "reference 2x32 chunk 8": (2, 32, 2, 8, 8, 8, False),
    "reference 1x64 chunk 16": (1, 64, 4, 16, 16, 16, False),
    "reference 2x128 chunk 32": (2, 128, 4, 32, 16, 32, False),
    "mamba2_train": (2, 1024, 80, 64, 128, 128, True),
    "ragged S=1000": (1, 1000, 80, 64, 128, 128, False),
    "one chunk S=128": (1, 128, 80, 64, 128, 128, False),
    "zamba2 N=64": (2, 1024, 80, 64, 64, 128, True),
}
#: the backward's five kernels a call, on either route: the chunk pass, the
#: state pass, the gradient pass and the reductions over heads and over
#: chunks
SSD_BWD_KERNELS = ("ssd_bwd_",)
#: the mamba2 and zamba2 training runs: the launcher's flags (seed-0 weights
#: drawn on the card, no checkpoint), 2 microbatches of 2 x 1024 tokens. lr
#: 1e-4: at 3e-4 zamba2's third loss jumped (10.87, 9.57, 15.47, then 9.93
#: and 9.66) while its reduced gradients matched the CPU's (PERF.md §6)
SSM_TRAIN_ARGS = ["--global-batch", "4", "--seq-len", "1024", "--microbatches", "2",
                  "--steps", "3", "--lr", "1e-4", "--ckpt-every", "0"]


def flash_bwd_inputs(c: dict, dtype, seed: int):
    rng = np.random.default_rng(seed)
    q = randn_dev(rng, (c["B"], c["Sq"], c["H"], c["D"]), torch.float32) * c.get("q_scale", 1.0)
    k, v = (randn_dev(rng, (c["B"], c["Skv"], c["KH"], c["D"]), dtype) for _ in range(2))
    do = randn_dev(rng, (c["B"], c["Sq"], c["H"], c["D"]), dtype)
    return q.to(dtype), k, v, do


def flash_kernel_grads(q, k, v, do, mask: dict):
    """dq, dk, dv through the wrapper under autograd (forward kernel with
    the log-sum-exp, then the backward kernel)."""
    from repro_torch.kernels.flash_attention import ops

    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = ops.prefill_attention(qq, kk, vv, **mask)
    if out.grad_fn is None:
        raise AssertionError("the flash wrapper returned no autograd node under grad")
    return torch.autograd.grad(out, (qq, kk, vv), do)


def bwd_route(c: dict, dtype) -> str:
    """The route the backward must take on a case's contiguous operands:
    the tensor cores for bf16 at D <= 128, else the CUDA cores."""
    return "tensor_core" if dtype == torch.bfloat16 and c["D"] <= 128 else "cuda_core"


def check_flash_bwd_cases() -> float:
    """Each backward case in f32 and bf16 against the plain backward
    (autograd through ``blockwise_attention`` in f32), each gradient held
    to ``ATOL`` of its dtype relative to its own largest entry, each on the
    route it must take (``bwd_route``); each band must reject the plain
    gradient without the case's softcap or window, or under the other
    mask. Returns the largest error (relative to each gradient's largest
    entry)."""
    from repro_torch.kernels.flash_attention import ops, ref

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATOL[str(dtype).removeprefix("torch.")]
        for name, c in FLASH_BWD_CASES.items():
            q, k, v, do = flash_bwd_inputs(c, dtype, seed=11)
            mask = dict(causal=c["causal"], window=c.get("window"), cap=c.get("cap"))
            before = ops.KERNEL.backward_launches
            route = bwd_route(c, dtype)
            routed = ops.KERNEL.backward_kernel.routes[route]
            got = flash_kernel_grads(q, k, v, do, mask)
            torch.cuda.synchronize()
            if DEVICE == "cuda" and (ops.KERNEL.backward_launches != before + 1
                                     or ops.KERNEL.backward_kernel.routes[route] != routed + 1):
                raise AssertionError(f"the backward did not launch its {route} kernel once")
            want = ref.flash_attention_bwd_ref(q, k, v, do, **mask)
            wrong = {}
            if "cap" in c:
                wrong["softcap"] = dict(mask, cap=None)
            if "window" in c:
                wrong["window"] = dict(mask, window=None)
            wrong["the causal mask" if c["causal"] else "bidirectional attention"] = dict(
                mask, causal=not c["causal"])
            plain_wrong = {f: ref.flash_attention_bwd_ref(q, k, v, do, **m)
                           for f, m in wrong.items()}
            for i, grad in enumerate("qkv"):
                s = want[i].abs().max()
                case = (f"flash backward {name} d{grad} {str(dtype).removeprefix('torch.')} "
                        f"{route}")
                if got[i].dtype != dtype or got[i].shape != want[i].shape:
                    raise AssertionError(f"{case}: {got[i].dtype} {tuple(got[i].shape)}")
                worst = max(worst, check_close(case, got[i] / s, want[i] / s, tol))
                check_band_binds(case, want[i] / s,
                                 {f: w[i] / s for f, w in plain_wrong.items()}, tol)
    return worst


def time_flash_bwd() -> dict:
    """The backward kernel at qwen's training shape in bf16, on the route
    the training path takes (tensor cores) and forced onto the CUDA cores
    on the same input: events and device time a call (the profiler's, and
    CUDA events behind a spin kernel), the plain backward's time, the
    bound (the five products' operations over the visible pairs at the
    bf16 peak, or the bytes: q, k, v, O, dO and the log-sum-exp read, dq,
    dk, dv written), and SDPA's backward through autograd at the same
    shape, its device time by the events behind a spin kernel."""
    from repro_torch.kernels.flash_attention import ops, ref

    c = FLASH_BWD_CASES["qwen_train"]
    B, S, H, D = c["B"], c["Sq"], c["H"], c["D"]
    q, k, v, do = flash_bwd_inputs(c, torch.bfloat16, seed=12)
    out, lse = ops.KERNEL(q, k, v, seq_dim=1, head_dim=2, causal=True, window=None,
                          softcap=None, q_offset=0, with_lse=True)

    def kernel(route=None):
        return ops.KERNEL.backward(q, k, v, out, do, lse, seq_dim=1, head_dim=2, causal=True,
                                   window=None, softcap=None, route=route)

    def kernel_calls(route=None):
        for _ in range(10):
            kernel(route)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

    lib_grads = [g.transpose(1, 2) for g in library()]
    routes = dict(ops.KERNEL.backward_kernel.routes)
    for name, got, want in zip("qkv", kernel(), lib_grads):
        check_yardstick(f"SDPA backward d{name} (qwen_train)", want, got)
    if DEVICE == "cuda" and (ops.KERNEL.backward_kernel.routes["tensor_core"]
                             != routes["tensor_core"] + 1):
        raise AssertionError("the timed backward did not take the tensor-core route")
    cuda_core = device_ms_per_call(lambda: kernel_calls("cuda_core"), 10, FLASH_BWD_KERNELS)
    return dict(B=B, S=S, H=H, D=D, causal=True, route="tensor_core",
                ms=time_call(kernel, 10),
                **device_ms_per_call(kernel_calls, 10, FLASH_BWD_KERNELS),
                device_ms_behind_spin=device_ms_behind_spin(kernel, 20),
                cuda_core_device_ms=cuda_core["device_ms"],
                cuda_core_device_kernels_ms=cuda_core["device_kernels_ms"],
                plain_ms=time_call(lambda: ref.flash_attention_bwd_ref(q, k, v, do, causal=True),
                                   3),
                library="scaled_dot_product_attention backward (autograd)",
                library_ms=time_call(library, 10),
                library_device_ms=device_ms_behind_spin(library, 20),
                library_device_ms_by="CUDA events around one call queued behind a "
                                     f"torch.cuda._sleep({SPIN_CYCLES}) spin, median of 20",
                **bound_of(ops.backward_cost(q, k, v, seq_dim=1, head_dim=2, causal=True)))


def ssd_bwd_case(c, dtype, with_dfinal: bool, seed: int):
    """The leaves (x, B, C, or the fused tensor they are sliced from; dt;
    A), a function from leaves to the scan's operands, dy and the final
    state's cotangent (or None), on the card, scaled as the model's (dt
    near 0.05)."""
    b, s, h, p, n, _, fused = c
    rng = np.random.default_rng(seed)
    if fused:
        leaves = [randn_dev(rng, (b, s, h * p + 2 * n), dtype)]

        def operands(xbc, dt, A):
            return (xbc[..., :h * p].reshape(b, s, h, p), dt, A, xbc[..., h * p:h * p + n],
                    xbc[..., h * p + n:])
    else:
        leaves = [randn_dev(rng, (b, s, h, p), dtype), randn_dev(rng, (b, s, n), dtype),
                  randn_dev(rng, (b, s, n), dtype)]

        def operands(x, B, C, dt, A):
            return x, dt, A, B, C
    leaves.append(torch.nn.functional.softplus(randn_dev(rng, (b, s, h), torch.float32) - 3.0))
    leaves.append(-randn_dev(rng, (h,), torch.float32).abs())
    dy = randn_dev(rng, (b, s, h, p), dtype)
    dfinal = randn_dev(rng, (b, h, p, n), torch.float32) if with_dfinal else None
    return leaves, operands, dy, dfinal


def ssd_kernel_grads(leaves, operands, dy, dfinal, chunk):
    """dx, ddt, dA, dB, dC through ``ssd`` under autograd (the forward
    kernel, then the backward kernel), split from the leaves' gradients."""
    from repro_torch.kernels.ssd import ops

    ls = [t.detach().clone().requires_grad_(True) for t in leaves]
    y, final = ops.ssd(*operands(*ls), chunk=chunk)
    if y.grad_fn is None:
        raise AssertionError("the SSD wrapper returned no autograd node under grad")
    outs, grads = ([y, final], [dy, dfinal]) if dfinal is not None else ([y], [dy])
    torch.autograd.backward(outs, grads)
    return operands(*[t.grad for t in ls])


#: the gradients each dropped part of the backward moves (dC reads the
#: forward state, not the state's gradient), for ``check_band_binds``
SSD_BWD_DROPS = {
    "the reverse state pass": (dict(carry_gradient=False), "x dt A B"),
    "the carried state": (dict(carry_state=False), "dt A C"),
    "the decay's gradient": (dict(decay_gradient=False), "dt A"),
    "the causal mask": (dict(causal=False), "x dt A B C"),
}


def ssd_bwd_route(c, dtype) -> str:
    """The route the SSD backward must take on a case's operands: the
    tensor cores for bf16 at P and N multiples of 16 and a chunk that is a
    multiple of 64 (every case here is aligned and fits a block), else the
    CUDA cores."""
    _, _, _, p, n, chunk, _ = c
    tc = dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0 and chunk % 64 == 0
    return "tensor_core" if tc else "cuda_core"


def check_ssd_bwd_cases() -> dict:
    """The SSD backward kernel through ``ssd`` under autograd against its
    plain version (autograd through ``ssd_reference`` in f32) on each case,
    each gradient within ``ATOL`` of its dtype relative to its own largest
    entry; each band shown to reject the passes' plain version with a part
    dropped: the reverse state pass (where there is an inter-chunk gradient
    or a final-state cotangent), the carried state (more than one chunk),
    the decay's gradient and the causal mask. Two calls on one input equal
    bit for bit, on inputs whose forward and backward take either route,
    and equal to a direct call of the backward kernel. Each case asserts
    its backward's route (``ssd_bwd_route``). Returns the largest error
    (relative to each gradient's largest entry) and the cases' routes."""
    from repro_torch.kernels.ssd import ops, ref

    worst, routes_seen = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATOL[str(dtype).removeprefix("torch.")]
        for name, c in SSD_BWD_CASES.items():
            chunk, chunks = c[5], -(-c[1] // c[5])
            for with_dfinal in (False, True):
                leaves, operands, dy, dfinal = ssd_bwd_case(c, dtype, with_dfinal, seed=21)
                before = (ops.KERNEL.launches, ops.KERNEL.backward_launches,
                          dict(ops.KERNEL.routes))
                bwd_route = ssd_bwd_route(c, dtype)
                routed = ops.KERNEL.backward_kernel.routes[bwd_route]
                got = ssd_kernel_grads(leaves, operands, dy, dfinal, chunk)
                torch.cuda.synchronize()
                fwd_route = next((r for r, n in ops.KERNEL.routes.items()
                                  if n != before[2][r]), None)
                if DEVICE == "cuda" and (ops.KERNEL.launches, ops.KERNEL.backward_launches) != (
                        before[0] + 1, before[1] + 1):
                    raise AssertionError(f"ssd backward {name}: not one forward and one "
                                         "backward launch")
                if DEVICE == "cuda" and ops.KERNEL.backward_kernel.routes[bwd_route] != routed + 1:
                    raise AssertionError(f"ssd backward {name} {dtype}: the backward did not "
                                         f"take its {bwd_route} route")
                ops_ = operands(*leaves)
                want = ref.ssd_bwd_ref(*ops_, dy, dfinal, chunk=chunk)
                drops = {f: (kw, grads) for f, (kw, grads) in SSD_BWD_DROPS.items()
                         if (f != "the reverse state pass" or chunks > 1 or with_dfinal)
                         and (f != "the carried state" or chunks > 1)}
                wrong = {f: ref.ssd_backward_passes_ref(*ops_, dy, dfinal, chunk=chunk, **kw)
                         for f, (kw, _) in drops.items()}
                tag = (f"{str(dtype).removeprefix('torch.')} "
                       f"{'dfinal' if with_dfinal else 'no dfinal'} forward {fwd_route} "
                       f"backward {bwd_route}")
                routes_seen[f"{name} {tag}"] = (fwd_route, bwd_route)
                for i, grad in enumerate(("x", "dt", "A", "B", "C")):
                    sc = want[i].abs().max()
                    case = f"ssd backward {name} d{grad} {tag}"
                    if got[i].dtype != ops_[i].dtype or got[i].shape != ops_[i].shape:
                        raise AssertionError(f"{case}: {got[i].dtype} {tuple(got[i].shape)}")
                    worst = max(worst, check_close(case, got[i] / sc, want[i] / sc, tol))
                    check_band_binds(case, want[i] / sc,
                                     {f: w[i].float() / sc for f, w in wrong.items()
                                      if grad in drops[f][1].split()}, tol)
    # bit for bit: bf16 slices of the fused tensor (the forward and the
    # backward on the tensor cores) and f32 (both on the CUDA cores); the
    # three calls of a dtype take one backward route, asserted
    repeat = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = SSD_BWD_CASES["mamba2_train"]
        leaves, operands, dy, dfinal = ssd_bwd_case(c, dtype, True, seed=22)
        before = dict(ops.KERNEL.routes)
        bwd_route = ssd_bwd_route(c, dtype)
        routed = ops.KERNEL.backward_kernel.routes[bwd_route]
        first = ssd_kernel_grads(leaves, operands, dy, dfinal, c[5])
        second = ssd_kernel_grads(leaves, operands, dy, dfinal, c[5])
        direct = ops.KERNEL.backward(*operands(*leaves), dy, dfinal, chunk=c[5])
        torch.cuda.synchronize()
        route = next((r for r, n in ops.KERNEL.routes.items() if n != before[r]), None)
        if DEVICE == "cuda" and ops.KERNEL.backward_kernel.routes[bwd_route] != routed + 3:
            raise AssertionError(f"the repeated SSD backwards ({dtype}) did not all take "
                                 f"the {bwd_route} route")
        equal = all(torch.equal(a, b) and torch.equal(a, d)
                    for a, b, d in zip(first, second, direct))
        repeat[str(dtype).removeprefix("torch.")] = dict(forward_route=route,
                                                         backward_route=bwd_route,
                                                         bit_equal=equal)
        if not equal:
            raise AssertionError(f"two SSD backward calls differ ({dtype}, forward {route}, "
                                 f"backward {bwd_route})")
    rec = dict(max_rel_err=worst, repeat=repeat, routes=routes_seen)
    log("ssd backward cases " + json.dumps(rec))
    return rec


def check_ssd_bwd_large_decay() -> dict:
    """The backward at mamba2's training shape with dt as full-width random
    weights give it (softplus of a unit normal, ~0.7; a chunk's Σ dt·|A|
    passes 88): autograd through ``ssd_reference`` turns NaN there (its
    ``where(mask, exp(cum_i - cum_j), 0)`` overflows above the diagonal,
    ROADMAP §3), so the kernel is held to the passes' plain version, which
    masks before the exp, and must be finite."""
    from repro_torch.kernels.ssd import ops, ref

    c = SSD_BWD_CASES["mamba2_train"]
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATOL[str(dtype).removeprefix("torch.")]
        leaves, operands, dy, _ = ssd_bwd_case(c, dtype, False, seed=24)
        rng = np.random.default_rng(25)
        leaves[-2] = torch.nn.functional.softplus(randn_dev(rng, tuple(leaves[-2].shape),
                                                            torch.float32))
        bwd_route = ssd_bwd_route(c, dtype)
        routed = ops.KERNEL.backward_kernel.routes[bwd_route]
        got = ssd_kernel_grads(leaves, operands, dy, None, c[5])
        if DEVICE == "cuda" and ops.KERNEL.backward_kernel.routes[bwd_route] != routed + 1:
            raise AssertionError(f"ssd backward large decay {dtype}: not on {bwd_route}")
        ops_ = operands(*leaves)
        want = ref.ssd_backward_passes_ref(*ops_, dy, None, chunk=c[5])
        autograd_nan = sum(int(torch.isnan(g).sum()) for g in ref.ssd_bwd_ref(*ops_, dy, None,
                                                                             chunk=c[5]))
        dtype_name = str(dtype).removeprefix("torch.")
        for i, grad in enumerate(("x", "dt", "A", "B", "C")):
            if not torch.isfinite(got[i]).all():
                raise AssertionError(f"ssd backward large decay d{grad} {dtype_name}: not finite")
            sc = want[i].float().abs().max()
            check_close(f"ssd backward large decay d{grad} {dtype_name} vs the passes' plain "
                        "version", got[i] / sc, want[i].float() / sc, tol)
        rec[dtype_name] = dict(backward_route=bwd_route, autograd_nan_entries=autograd_nan,
                               max_chunk_decay=float((leaves[-2] * leaves[-1].abs()).reshape(
                                   c[0], -1, c[5], c[2]).sum(2).max()))
    log("ssd backward large decay " + json.dumps(rec))
    return rec


def time_ssd_bwd() -> dict:
    """The backward kernel at mamba2's training shape (a microbatch of 2 x
    1024 tokens, bf16 slices of the fused tensor, no final-state
    cotangent, as training calls it), on the route training takes (tensor
    cores) and forced onto the CUDA cores on the same input: events and
    device time a call (the profiler's, all five kernels by pass, and CUDA
    events behind a spin kernel), the forward's device time on the same
    input (behind a spin kernel), the plain backward's time, the bound. The
    profiler's time is the sum of per-instance means
    (``device_ms_by_instance``). No single PyTorch call computes the scan's
    backward, so there is no library time."""
    from repro_torch.kernels.ssd import ops, ref

    c = SSD_BWD_CASES["mamba2_train"]
    b, S, h, p, n, Q, _ = c
    leaves, operands, dy, _ = ssd_bwd_case(c, torch.bfloat16, False, seed=23)
    args = operands(*leaves)

    def kernel(route=None):
        return ops.KERNEL.backward(*args, dy, None, chunk=Q, route=route)

    def kernel_calls(route=None):
        for _ in range(10):
            kernel(route)

    routes = dict(ops.KERNEL.backward_kernel.routes)
    kernel()
    if DEVICE == "cuda" and (ops.KERNEL.backward_kernel.routes["tensor_core"]
                             != routes["tensor_core"] + 1):
        raise AssertionError("the timed SSD backward did not take the tensor-core route")
    cuda_core = device_ms_by_instance(lambda: kernel_calls("cuda_core"), SSD_BWD_KERNELS, 5)
    return dict(B=b, S=S, H=h, P=p, N=n, chunk=Q, dtype="bfloat16", fused_slices=True,
                route="tensor_core", ms=time_call(kernel, 10),
                **device_ms_by_instance(kernel_calls, SSD_BWD_KERNELS, 5),
                device_ms_behind_spin=device_ms_behind_spin(kernel, 20),
                cuda_core_device_ms=cuda_core["device_ms"],
                cuda_core_device_kernels_ms=cuda_core["device_kernels_ms"],
                cuda_core_device_ms_behind_spin=device_ms_behind_spin(
                    lambda: kernel("cuda_core"), 5),
                forward_device_ms_behind_spin=device_ms_behind_spin(
                    lambda: ops.KERNEL(*args, chunk=Q), 20),
                plain_ms=time_call(lambda: ref.ssd_bwd_ref(*args, dy, None, chunk=Q), 3),
                library_ms=None,
                library_note="no single PyTorch call computes the SSD scan's backward",
                **with_f32_ops(ops.backward_cost(*args, chunk=Q)))


def check_train_small(arch: str = "qwen1.5-0.5b") -> dict:
    """A reduced model (qwen, mamba2 or zamba2): ``Model.loss`` and the
    gradient of every leaf on the card (the flash and SSD forward and
    backward kernels) against the CPU (plain versions), same bf16 weights
    and tokens: the loss within 1e-2 relative, each leaf within 5e-2
    relative Frobenius error (the bands of tests/test_torch_loss.py in
    bf16); each kernel launched once a layer it runs in, forward and
    backward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import Model, materialize
    from repro_torch.models.params import flatten_tree

    cfg = get_config(arch).reduced()
    groups = cfg.num_layers // cfg.shared_attn_period if cfg.family == "hybrid" else 0
    ssm = cfg.family in ("ssm", "hybrid")
    kernels = {"flash": flash_ops.KERNEL, "ssd": ssd_ops.KERNEL}
    want = {"flash": groups if ssm else cfg.num_layers, "ssd": cfg.num_layers if ssm else 0}
    params = materialize(Model(cfg).describe(), seed=0)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(1, cfg.vocab_size, (2, 129)))
    res = {}
    for dev in ("cpu", DEVICE):
        p = _to(params, dev)
        for _, t in flatten_tree(p):
            t.requires_grad_(True)
        before = {k: (kern.launches, kern.backward_launches) for k, kern in kernels.items()}
        loss, _ = Model(cfg, p).loss({"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(loss, [t for _, t in flatten_tree(p)])
        res[dev] = (loss.item(), [g.float().cpu() for g in grads],
                    {k: (kern.launches - before[k][0], kern.backward_launches - before[k][1])
                     for k, kern in kernels.items()})
    (l_cpu, g_cpu, _), (l_dev, g_dev, counts) = res["cpu"], res[DEVICE]
    worst = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_dev, g_cpu))
    rec = dict(arch=arch, loss_cpu=l_cpu, loss_card=l_dev,
               loss_rel=abs(l_dev - l_cpu) / abs(l_cpu), worst_leaf_rel_frobenius=worst,
               **{f"{k}_launches": n[0] for k, n in counts.items()},
               **{f"{k}_backward_launches": n[1] for k, n in counts.items()})
    log("train small " + json.dumps(rec))
    if not (rec["loss_rel"] <= 1e-2 and worst <= 5e-2 and math.isfinite(l_dev)):
        raise AssertionError(f"{arch}: the reduced loss or its gradients on the card disagree "
                             "with the CPU")
    if DEVICE == "cuda" and any(counts[k] != (n, n) for k, n in want.items()):
        raise AssertionError(f"{arch}: a reduced loss ran {counts} forwards and backwards, "
                             f"not {want} each")
    return rec


def step_breakdown(trainer, state, model) -> dict:
    """One more optimizer step, on the host clock (synchronized) and under
    ``torch.profiler``: the device's kernel time, its share of the
    unprofiled step (and of the profiled one),
    and the kernels that took most of it, grouped (the flash and SSD
    kernels, forward and backward, products, the rest)."""
    tokens = trainer._tokens_for(state.step)
    trainer.train_step(state, tokens, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(state, tokens, model)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, tokens, model)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    # the step's ``train.*`` ranges (loop.py) also show on the device as
    # annotations, which are no kernels
    counts: dict = {}
    kernels = {k: us for k, us in device_kernel_us(prof, counts).items()
               if not k.startswith("train.")}
    device_ms = sum(kernels.values()) / 1e3
    # the kernels launched inside each range, from its host-side event (the
    # backward runs on autograd's thread, outside them: it is the rest)
    ranges: dict = {}
    for ev in prof.events():
        if ev.name.startswith("train.") and ev.device_type == torch.autograd.DeviceType.CPU:
            ranges[ev.name] = ranges.get(ev.name, 0.0) + ev.device_time_total / 1e3
    ranges["backward (the rest)"] = device_ms - sum(ranges.values())
    groups = {"flash_forward": 0.0, "flash_backward": 0.0, "ssd_forward": 0.0,
              "ssd_backward": 0.0, "products": 0.0, "other": 0.0}
    for name, us in kernels.items():
        if "flash_mma_kernel" in name or "flash_attention_kernel" in name:
            groups["flash_forward"] += us / 1e3
        elif any(k in name for k in FLASH_BWD_KERNELS):
            groups["flash_backward"] += us / 1e3
        elif any(k in name for k in SSD_BWD_KERNELS):
            groups["ssd_backward"] += us / 1e3
        elif any(k in name for k in SSD_KERNEL_NAMES):
            groups["ssd_forward"] += us / 1e3
        elif any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
            groups["products"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    # the share is of the step without the profiler, whose own host work
    # would make the step look more host-bound than it is
    return dict(step_host_ms=host_ms, profiled_step_host_ms=profiled_ms,
                step_device_ms=device_ms, device_share=device_ms / host_ms,
                device_share_of_profiled_step=device_ms / profiled_ms,
                device_ms_by_group=groups, device_ms_by_range=ranges,
                top_kernels_ms={k[:80]: v / 1e3 for k, v in top},
                # the profile can lose records (PERF.md §7): what it held of
                # the two backwards' largest kernels
                profiled_instances={k[:60]: counts[k] for k in kernels
                                    if "ssd_bwd_grad" in k or "flash_bwd_dq" in k})


def train_full() -> dict:
    """qwen1.5-0.5b at full width through the launcher's code path
    (``parse_args`` → ``build_trainer`` → ``train``): seed-0 weights drawn
    on the card, 6 steps of 2 microbatches of 4 x 1024 tokens, remat on.
    Every loss finite and the last below the first; the flash forward
    launched 2 x layers x microbatches x steps times (remat recomputes each
    block's forward in the backward), its backward layers x microbatches x
    steps, every one on the tensor cores; peak memory; then one step's
    time on the host clock and on the device."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.params import leaves

    args = launch_train.parse_args(TRAIN_ARGS + ["--device", DEVICE])
    trainer = launch_train.build_trainer(args)
    trainer.tcfg.log_every = 1
    cfg, tcfg = trainer.cfg, trainer.tcfg
    n_params = sum(math.prod(l.shape) for _, l in leaves(trainer.param_tree))
    t0 = time.perf_counter()
    state = trainer.adopt(draw_on_card(trainer.param_tree, seed=0))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.KERNEL.launches = 0
    ops.KERNEL.backward_launches = 0
    routes = ops.KERNEL.backward_kernel.routes
    routes.update(dict.fromkeys(routes, 0))
    t0 = time.perf_counter()
    state = launch_train.train(trainer, state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = ops.KERNEL.launches, ops.KERNEL.backward_launches
    bwd_routes = dict(routes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics]
    rec = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, params=n_params,
               remat=cfg.remat, global_batch=args.global_batch, seq_len=args.seq_len,
               microbatches=tcfg.microbatches, steps=state.step, lr=tcfg.lr,
               weights="drawn on the card (torch.Generator, seed 0)", draw_s=draw_s,
               run_s=run_s, losses=losses, flash_launches=fwd, backward_launches=bwd,
               backward_routes=bwd_routes,
               flash_launches_expected=2 * cfg.num_layers * tcfg.microbatches * tcfg.steps,
               backward_launches_expected=cfg.num_layers * tcfg.microbatches * tcfg.steps,
               peak_gib=peak)
    rec.update(step_breakdown(trainer, state, Model(cfg, state.params)))
    log("train " + json.dumps(rec))
    if len(losses) != tcfg.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the training losses are missing or not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {tcfg.steps} steps: {losses}")
    if DEVICE == "cuda" and (fwd, bwd) != (rec["flash_launches_expected"],
                                           rec["backward_launches_expected"]):
        raise AssertionError(f"training ran {fwd} flash forwards and {bwd} backwards")
    if DEVICE == "cuda" and bwd_routes["tensor_core"] != bwd:
        raise AssertionError(f"training's backwards did not all take the tensor cores: "
                             f"{bwd_routes}")
    return rec


def train_ssm(arch: str) -> dict:
    """An SSD-scan model at full width and depth through the launcher's code
    path (``parse_args`` → ``build_trainer`` → ``train``): seed-0 weights
    drawn on the card, 3 steps of 2 microbatches of 2 x 1024 tokens, remat
    on. Every loss finite and the last below the first; the SSD forward
    launched 2 x mamba layers x microbatches x steps times (remat
    recomputes each block's forward in the backward), its backward mamba
    layers x microbatches x steps; for the hybrid, the shared block's flash
    forward and backward likewise per group, every backward on the CUDA
    cores (D = 160); every SSD backward on the tensor cores; peak memory;
    then one step's time on the host clock
    and on the device, and the SSD backward's share of the device time."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.params import leaves

    args = launch_train.parse_args(["--arch", arch, *SSM_TRAIN_ARGS, "--device", DEVICE])
    trainer = launch_train.build_trainer(args)
    trainer.tcfg.log_every = 1
    cfg, tcfg = trainer.cfg, trainer.tcfg
    n_params = sum(math.prod(l.shape) for _, l in leaves(trainer.param_tree))
    t0 = time.perf_counter()
    state = trainer.adopt(draw_on_card(trainer.param_tree, seed=0))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = (ssd_ops.KERNEL, flash_ops.KERNEL)
    for k in counters:
        k.launches = 0
        k.backward_launches = 0
    for routes in (ssd_ops.KERNEL.routes, ssd_ops.KERNEL.backward_kernel.routes,
                   flash_ops.KERNEL.backward_kernel.routes):
        routes.update(dict.fromkeys(routes, 0))
    t0 = time.perf_counter()
    state = launch_train.train(trainer, state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics]
    runs = tcfg.microbatches * tcfg.steps
    groups = cfg.num_layers // cfg.shared_attn_period if cfg.family == "hybrid" else 0
    rec = dict(arch=cfg.name, layers=cfg.num_layers, layers_run=f"{cfg.num_layers} of "
               f"{cfg.num_layers}", d_model=cfg.d_model, ssd_heads=cfg.ssm_heads,
               ssd_head_dim=cfg.ssm_head_dim, ssd_state=cfg.ssm_state, params=n_params,
               remat=cfg.remat, global_batch=args.global_batch, seq_len=args.seq_len,
               microbatches=tcfg.microbatches, steps=state.step, lr=tcfg.lr,
               weights="drawn on the card (torch.Generator, seed 0)", draw_s=draw_s,
               run_s=run_s, losses=losses,
               ssd_launches=ssd_ops.KERNEL.launches,
               ssd_routes=dict(ssd_ops.KERNEL.routes),
               ssd_backward_launches=ssd_ops.KERNEL.backward_launches,
               ssd_backward_routes=dict(ssd_ops.KERNEL.backward_kernel.routes),
               ssd_launches_expected=2 * cfg.num_layers * runs,
               ssd_backward_launches_expected=cfg.num_layers * runs,
               peak_gib=peak)
    if groups:
        rec.update(shared_block_groups=groups, flash_launches=flash_ops.KERNEL.launches,
                   flash_backward_launches=flash_ops.KERNEL.backward_launches,
                   flash_backward_routes=dict(flash_ops.KERNEL.backward_kernel.routes),
                   flash_launches_expected=2 * groups * runs,
                   flash_backward_launches_expected=groups * runs)
    rec.update(step_breakdown(trainer, state, Model(cfg, state.params)))
    rec["ssd_backward_share_of_device"] = (rec["device_ms_by_group"]["ssd_backward"]
                                           / rec["step_device_ms"])
    rec["profiled_instances_expected"] = dict(ssd_bwd_grad=cfg.num_layers * tcfg.microbatches,
                                              flash_bwd_dq=groups * tcfg.microbatches)
    log(f"train {arch} " + json.dumps(rec))
    if len(losses) != tcfg.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: the training losses are missing or not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall over {tcfg.steps} steps: {losses}")
    if DEVICE == "cuda":
        want = {k: rec[f"{k}_expected"] for k in (
            "ssd_launches", "ssd_backward_launches", "flash_launches", "flash_backward_launches")
            if f"{k}_expected" in rec}
        if any(rec[k] != v for k, v in want.items()):
            raise AssertionError(f"{arch}: launches { {k: rec[k] for k in want} } against {want}")
        if rec["ssd_backward_routes"]["tensor_core"] != rec["ssd_backward_launches"]:
            raise AssertionError(f"{arch}: the SSD backwards did not all take the tensor "
                                 f"cores: {rec['ssd_backward_routes']}")
        if groups and rec["flash_backward_routes"]["cuda_core"] != groups * runs:
            raise AssertionError(f"{arch}: the D = 160 flash backwards did not all take the "
                                 f"CUDA cores: {rec['flash_backward_routes']}")
    return rec


def train_restore() -> dict:
    """A reduced-qwen trainer on the card saves at step 2; a fresh trainer
    restores it onto the card, leaf for leaf bit-equal to what was saved."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models.params import flatten_tree
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import TrainConfig, Trainer

    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config("qwen1.5-0.5b").reduced()

    def trainer():
        return Trainer(cfg, TrainConfig(steps=2, microbatches=2, ckpt_every=2,
                                        ckpt_dir=str(ckpt_dir), log_every=1),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4),
                       device=DEVICE)

    saved = trainer().run()
    restored = trainer().resume_or_init()
    same = all(torch.equal(a.detach(), b.detach()) and b.device == a.device for (_, a), (_, b)
               in zip(flatten_tree({"p": saved.params, "o": saved.opt}),
                      flatten_tree({"p": restored.params, "o": restored.opt})))
    rec = dict(step=restored.step, device=str(restored.params["embed"].device), bit_equal=same,
               checkpoint_bytes=sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file()))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log("train restore " + json.dumps(rec))
    if not (same and restored.step == 2 and restored.params["embed"].device.type == DEVICE):
        raise AssertionError(f"the checkpoint did not restore onto the card: {rec}")
    return rec


# ------------------------------------------------------------ phase 11: the audit
#: the bound of every timing line that PERF.md §6 records, in ms to the
#: digits it gives (the account of ``ops.cost``; moved there unchanged)
RECORDED_BOUND_MS = {
    "paged main": 0.00090, "paged d160": 0.00358, "paged whisper cross": 0.00367,
    "flash monolithic": 0.00094, "flash dbrx": 0.00329, "flash d160": 0.00470,
    "flash d256": 0.00282, "flash gemma2_local": 0.17320, "flash whisper_encoder": 0.00932,
    "flash whisper_cross": 0.00191, "flash internvl2": 0.00911, "flash backward": 0.02173,
    f"ssd S={SSD_MAIN_S}": 0.00241, "ssd zamba2": 0.00280, "ssd backward": 0.02282,
}


def meta(*shape, dtype=torch.bfloat16):
    """An operand of ``shape`` and ``dtype`` with no data, for a cost."""
    return torch.empty(shape, dtype=dtype, device="meta")


def account_costs(paged_timing, paged_d160, paged_cross, flash_timing, ssd_timing,
                  bwd_timing, ssd_bwd_timing) -> dict:
    """Each timing line's shapes, as the line prints them, through the
    kernels' ``cost``: ``{line: (cost, the line's record)}``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    def paged(rec):
        B, H, KH, D, T, P = rec["shape"]
        return paged_ops.cost(meta(B, H, D), meta(1, T, KH, D),
                              meta(B, P, dtype=torch.int32), rec["lengths"],
                              k_new=meta(B, KH, D))

    c = paged_cross
    out = {"paged main": (paged(paged_timing), paged_timing),
           "paged d160": (paged(paged_d160), paged_d160),
           "paged whisper cross": (paged_ops.cost(
               meta(c["B"], c["H"], c["D"]), meta(1, c["page_tokens"], c["KH"], c["D"]),
               meta(c["B"], c["S"] // c["page_tokens"], dtype=torch.int32),
               [c["S"]] * c["B"]), c)}
    for name, r in flash_timing.items():
        out[f"flash {name}"] = (flash_ops.prefill_cost(
            meta(r["B"], r["Sq"], r["H"], r["D"]), meta(r["B"], r["Skv"], r["KH"], r["D"]),
            meta(r["B"], r["Skv"], r["KH"], r["D"]), causal=r["causal"], window=r["window"],
            q_offset=r["q_offset"], kv_hole=r["kv_hole"]), r)
    b = bwd_timing
    q = meta(b["B"], b["S"], b["H"], b["D"])
    out["flash backward"] = (flash_ops.backward_cost(q, q, q, seq_dim=1, head_dim=2,
                                                     causal=b["causal"]), b)

    def ssd_operands(bsz, S, h, p, n):
        return (meta(bsz, S, h, p), meta(bsz, S, h, dtype=torch.float32),
                meta(h, dtype=torch.float32), meta(bsz, S, n), meta(bsz, S, n))

    m = SSD_MAIN
    for S, r in [(SSD_MAIN_S, ssd_timing), *ssd_timing["by_s"].items()]:
        out[f"ssd S={S}"] = (ssd_ops.cost(*ssd_operands(m["b"], int(S), m["h"], m["p"],
                                                         m["n"]), chunk=m["chunk"]), r)
    z = ssd_timing["zamba2"]
    out["ssd zamba2"] = (ssd_ops.cost(*ssd_operands(z["b"], z["S"], z["h"], z["p"], z["n"]),
                                      chunk=z["chunk"]), z)
    r = ssd_bwd_timing
    out["ssd backward"] = (ssd_ops.backward_cost(*ssd_operands(r["B"], r["S"], r["H"], r["P"],
                                                               r["N"]), chunk=r["chunk"]), r)
    return out


def check_account(timings: dict) -> dict:
    """Every timing line's bytes, operations and bound equal what the
    kernels' ``cost`` gives at the line's shapes, and every bound that
    PERF.md §6 records equals it to the digits recorded there."""
    checked = {}
    for line, (cost, rec) in timings.items():
        want = bound_of(cost)
        got = {k: rec[k] for k in ("bytes", "operations", "bound_ms")}
        if got != {k: want[k] for k in got}:
            raise AssertionError(f"{line}: the line prints {got}, its cost gives {want}")
        if line in RECORDED_BOUND_MS and round(rec["bound_ms"], 5) != RECORDED_BOUND_MS[line]:
            raise AssertionError(f"{line}: bound {rec['bound_ms']} ms, PERF.md records "
                                 f"{RECORDED_BOUND_MS[line]}")
        checked[line] = rec["bound_ms"]
    missing = set(RECORDED_BOUND_MS) - set(checked)
    if missing:
        raise AssertionError(f"no timing line for the recorded bounds {sorted(missing)}")
    return checked


def audit_on_card(cfg, params, timings: dict) -> dict:
    """Phase 11: the step auditor and the lint on the card. The seeded
    selftest; the audit of full-width qwen engines with the launcher's
    pools (every paged decode bucket, every chunk-prefill spec, the
    dense-slot spec) and of the three kernel targets, with every captured
    bucket's replay timed against its bound: no violation; the replay
    gate: no capture after warmup; the timing lines' account; the port's
    lint over its default paths: clean."""
    from repro_torch.analysis import jitaudit, lint
    from repro_torch.launch.serve import ENGINE_POOLS
    from repro_torch.serving import Engine

    t0 = time.perf_counter()
    failures = jitaudit.selftest(DEVICE)
    if failures:
        raise AssertionError(f"jitaudit selftest: {failures}")
    paged = Engine(cfg, params, device=DEVICE, **ENGINE_POOLS)
    dense = Engine(cfg, params, device=DEVICE, dense_slots=True, **ENGINE_POOLS)
    paged.warmup(prefill_chunks=True)
    dense.warmup()
    targets = (jitaudit.engine_targets(paged, prefill_chunks=True)
               + jitaudit.engine_targets(dense, prefill_chunks=False)
               + jitaudit.kernel_targets(DEVICE))
    rows, violations = jitaudit.audit(targets)
    if violations:
        raise AssertionError("jitaudit: " + "; ".join(str(v) for v in violations))
    decode = [r for r in rows if r["kind"] in ("paged_decode", "dense")]
    shares = [r.get("replay_share") for r in decode]
    n_buckets = -(-paged.pages_per_slot // paged._table_bucket)
    if len(decode) != n_buckets + 1 or DEVICE == "cuda" and not all(
            s is not None and 0 < s <= jitaudit.REPLAY_SHARE_LIMIT for s in shares):
        raise AssertionError(f"decode buckets' roofline shares: {shares}")
    del paged, dense
    gate = jitaudit.replay_gate(cfg, params, device=DEVICE, log=log)
    if gate["post_warmup_captures"] or gate["captures_by_phase"]["replay"]:
        raise AssertionError(f"the replay gate captured after warmup: {gate}")
    account = check_account(timings)
    lint_files = lint._gather(lint.default_paths(str(ROOT)))
    lint_violations = lint.run(lint_files)
    if lint_violations:
        raise AssertionError("lint: " + "; ".join(str(v) for v in lint_violations))
    blockers = jitaudit.blocker_sites(rows)
    record = dict(
        selftest_failures=failures, targets=len(rows), violations=len(violations),
        kinds={k: sum(r["kind"] == k for r in rows) for k in sorted({r["kind"] for r in rows})},
        decode_buckets={r["target"]: dict(
            bucket=r["bucket"], flops=r["static"]["flops"], hbm_bytes=r["static"]["hbm_bytes"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], replay_ms=r.get("replay_ms"),
            replay_share=r.get("replay_share"), ratios=r["ratios"]) for r in decode},
        ratio_ranges={k: [min(r["ratios"][k] for r in rows), max(r["ratios"][k] for r in rows)]
                      for k in jitaudit.TOLERANCES},
        chunk_specs=sum(r["kind"] == "chunk_prefill" for r in rows),
        capture_blockers=blockers,
        replay_gate={k: gate[k] for k in ("post_warmup_captures", "captures_by_phase",
                                          "graph_replays")},
        account_lines=len(account), account_recorded=len(RECORDED_BOUND_MS),
        lint_files=len(lint_files), lint_violations=len(lint_violations),
        seconds=time.perf_counter() - t0)
    log("jitaudit " + json.dumps(record))
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.launch import serve

    # arm the compile tracker: a replay that captures a graph after its
    # engine's warmup raises at its end
    os.environ["REPRO_JITAUDIT"] = "1"
    # torch.compile (the flex_attention yardstick) caches inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    identity = gpu_identity()
    log(f"gpu: {identity}; torch {torch.__version__}, cuda {torch.version.cuda}")
    build_kernels()

    paged_err = check_kernel_cases()
    paged_timing = time_kernel(layers=24)
    log("paged_attention timing " + json.dumps(paged_timing))
    paged_d160 = time_kernel(D160_LAYERS, D160_SHAPE, D160_LENGTHS)
    log("paged timing d160 " + json.dumps(paged_d160))
    paged_cross = time_cross_decode()
    log("paged timing whisper cross " + json.dumps(paged_cross))
    flash_err = check_flash_cases()
    flash_timing = time_flash()
    log("flash_attention timing " + json.dumps(flash_timing))
    ssd_err = check_ssd_cases()
    ssd_timing = time_ssd()
    log("ssd timing " + json.dumps(ssd_timing))
    if "--kernels-only" in argv:
        check_flash_bwd_cases()
        log("flash_attention_bwd timing " + json.dumps(time_flash_bwd()))
        check_ssd_bwd_cases()
        check_ssd_bwd_large_decay()
        log("ssd_bwd timing " + json.dumps(time_ssd_bwd()))
        time_flex_yardstick(flash_timing)
        return 0

    check_model_small()
    check_mamba_small()
    args = serve.parse_args([])          # the launcher's defaults: full width, cuda
    mono, engines, serve_router = replay_paged(args, chunked=False)
    chunked, _, _ = replay_paged(args, chunked=True, cfg=engines[0].cfg,
                                 params=_param_tree(engines[0].model), label="serve_chunked")
    parity = graph_parity_paged(engines[0].cfg, _param_tree(engines[0].model))
    log("decode breakdown " + json.dumps(decode_breakdown(engines[0])))
    # phase 7 serves the same weights again
    qwen_cfg, qwen_params = engines[0].cfg, _param_tree(engines[0].model)
    serve_log = {pid: list(toks) for pid, toks in serve_router.output_log.items()}
    del engines, serve_router
    gc.collect()
    torch.cuda.empty_cache()
    ssm, ssm_engine = serve_ssm()
    parity += graph_parity_ssm(ssm_engine)
    log("ssm breakdown " + json.dumps(ssm_breakdown(ssm_engine)))
    del ssm_engine
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_parity = serve_moe(args, host_rate=ssm["params"] / ssm["materialize_s"])
    parity += moe_parity
    log("graph parity " + json.dumps({"cases": parity}))
    for case in parity:
        if not (case["max_abs_logit_diff"] == 0.0 and case["tokens_equal"]
                and case.get("pool_equal", True) and case.get("state_equal", True)):
            raise AssertionError(f"a replayed graph differs from its eager step: {case}")
        if DEVICE == "cuda" and case.get("paged_kernels_replayed", 0) != case.get("layers", 0):
            raise AssertionError(f"a decode graph did not run one paged kernel a layer: {case}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7: the reference's other serving modes at qwen's full width
    torch.cuda.reset_peak_memory_stats()
    paged_err = max(paged_err, check_dense_slot_view())
    dense = serve_dense_slots(args, qwen_cfg, qwen_params, serve_log)
    torch.cuda.reset_peak_memory_stats()
    replicas = serve_replicas(args, qwen_cfg, qwen_params)
    # phase 11 audits engines on these weights: they wait on the host
    qwen_params = _to(qwen_params, "cpu")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: gemma2's alternation and the zamba2 hybrid at model level
    gemma2 = model_gemma2()
    gc.collect()
    torch.cuda.empty_cache()
    zamba2 = model_zamba2()
    gc.collect()
    torch.cuda.empty_cache()
    # whisper's encoder-decoder and internvl2's image prefix at model level
    whisper = model_whisper()
    gc.collect()
    torch.cuda.empty_cache()
    internvl2 = model_internvl2()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 9: training through the flash and SSD kernels' forwards and
    # backwards
    bwd_err = check_flash_bwd_cases()
    bwd_timing = time_flash_bwd()
    log("flash_attention_bwd timing " + json.dumps(bwd_timing))
    ssd_bwd = check_ssd_bwd_cases()
    check_ssd_bwd_large_decay()
    ssd_bwd_timing = time_ssd_bwd()
    log("ssd_bwd timing " + json.dumps(ssd_bwd_timing))
    for arch in ("qwen1.5-0.5b", "mamba2-2.7b", "zamba2-2.7b"):
        check_train_small(arch)
    train = train_full()
    gc.collect()
    torch.cuda.empty_cache()
    train_restore()
    train_mamba2 = train_ssm("mamba2-2.7b")
    gc.collect()
    torch.cuda.empty_cache()
    train_zamba2 = train_ssm("zamba2-2.7b")
    gc.collect()
    torch.cuda.empty_cache()
    # last: after torch.compile a profile can lose kernel records, and the
    # replays' checks count kernels in profiles
    time_flex_yardstick(flash_timing)

    # phase 11: the audit of the step graphs, the account and the lint
    audit_on_card(qwen_cfg, _to(qwen_params, DEVICE), account_costs(
        paged_timing, paged_d160, paged_cross, flash_timing, ssd_timing, bwd_timing,
        ssd_bwd_timing))
    del qwen_params
    gc.collect()
    torch.cuda.empty_cache()

    ft = flash_timing["monolithic"]
    kernels = {"kernels": [
        {
            "name": "paged_attention_decode",
            "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:129",
            "replaces_function": "paged_attention",
            "launches": mono["kernel_launches"],
            "launches_moe_replay": moe["kernel_launches"],
            "launches_dense_slots_replay": dense["kernel_launches"],
            "launches_replicas_replay": replicas["kernel_launches"],
            "launches_gemma2_decode": gemma2["paged_kernel_launches_ring"],
            "launches_gemma2_full_cache_decode": gemma2["paged_kernel_launches_full"],
            "launches_zamba2_decode": zamba2["paged_kernel_launches"],
            "launches_whisper_decode": whisper["paged_kernel_launches"],
            "launches_internvl2_slot_decode": internvl2["paged_kernel_launches_slots"],
            "launches_internvl2_decode_paged": internvl2["paged_kernel_launches_pool"],
            "max_abs_err": paged_err,
            "ms": paged_timing["ms"],
            "device_ms": paged_timing["device_ms"],
            "kernel_ms": paged_timing["ms"],
            "plain_ms": paged_timing["plain_ms"],
            "bound_ms": paged_timing["bound_ms"],
            "bound_by": paged_timing["bound_by"],
            "library_ms": paged_timing["library_ms"],
            "library_device_ms": paged_timing["library_device_ms"],
            "d160": {k: paged_d160[k] for k in (
                "shape", "lengths", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")},
            "whisper_cross": {k: paged_cross[k] for k in (
                "B", "H", "S", "page_tokens", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")},
        },
        {
            "name": "flash_attention_prefill",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:108",
            "replaces_function": "flash_attention",
            "launches": mono["flash_launches"],
            "launches_chunked_replay": chunked["flash_launches"],
            "launches_moe_replay": moe["flash_launches"],
            "launches_dense_slots_replay": dense["flash_launches"],
            "launches_replicas_replay": replicas["flash_launches"],
            "launches_gemma2_prefills": gemma2["flash_launches"],
            "launches_zamba2_prefills": zamba2["flash_launches"],
            "launches_whisper_prefills": whisper["flash_launches"],
            "launches_internvl2_prefills": internvl2["flash_launches"],
            "launches_training": train["flash_launches"],
            "launches_zamba2_training": train_zamba2["flash_launches"],
            "max_abs_err": flash_err,
            "ms": ft["ms"],
            "device_ms": ft["device_ms"],
            "kernel_ms": ft["ms"],
            "plain_ms": ft["plain_ms"],
            "bound_ms": ft["bound_ms"],
            "bound_by": ft["bound_by"],
            "library_ms": ft["library_ms"],
            "library_device_ms": ft["library_device_ms"],
            "other_shapes": {name: {k: flash_timing[name][k] for k in (
                "H", "KH", "D", "Sq", "ms", "device_ms", "bound_ms", "bound_by", "library",
                "library_ms", "library_device_ms")}
                for name in (*FLASH_OTHER, "gemma2_local", *FLASH_MODELS)},
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/model.py:561",
            "replaces_note": "no TPU kernel: the reference's Model.loss is differentiated "
                             "through plain jnp (blockwise_attention); no Pallas kernel has a "
                             "backward",
            "launches": train["backward_launches"],
            "launches_zamba2_training": train_zamba2["flash_backward_launches"],
            "launches_zamba2_training_by_route": train_zamba2["flash_backward_routes"],
            "max_abs_err": bwd_err,
            "max_abs_err_note": "relative to each gradient's largest entry",
            "launches_by_route": train["backward_routes"],
            "ms": bwd_timing["ms"],
            "device_ms": bwd_timing["device_ms"],
            "device_ms_behind_spin": bwd_timing["device_ms_behind_spin"],
            "kernel_ms": bwd_timing["ms"],
            "device_kernels_ms": bwd_timing["device_kernels_ms"],
            "cuda_core_device_ms": bwd_timing["cuda_core_device_ms"],
            "plain_ms": bwd_timing["plain_ms"],
            "bound_ms": bwd_timing["bound_ms"],
            "bound_by": bwd_timing["bound_by"],
            "library_ms": bwd_timing["library_ms"],
            "library_device_ms": bwd_timing["library_device_ms"],
            "library_device_ms_by": bwd_timing["library_device_ms_by"],
            "shape": {k: bwd_timing[k] for k in ("B", "S", "H", "D", "causal", "route")},
        },
        {
            "name": "ssd_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:88",
            "replaces_function": "ssd",
            "launches": ssm["ssd_launches"],
            "launches_zamba2_prefills": zamba2["ssd_launches"],
            "launches_mamba2_training": train_mamba2["ssd_launches"],
            "launches_zamba2_training": train_zamba2["ssd_launches"],
            "max_abs_err": ssd_err,
            "ms": ssd_timing["ms"],
            "device_ms": ssd_timing["device_ms"],
            "kernel_ms": ssd_timing["ms"],
            "cuda_core_device_ms": ssd_timing["cuda_core_device_ms"],
            "plain_ms": ssd_timing["plain_ms"],
            "bound_ms": ssd_timing["bound_ms"],
            "bound_by": ssd_timing["bound_by"],
            "library_ms": None,
            "library_note": ssd_timing["library_note"],
            "zamba2": {k: ssd_timing["zamba2"][k] for k in (
                "S", "n", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        },
        {
            "name": "ssd_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
            "replaces": "src/repro/models/layers.py:550",
            "replaces_note": "no TPU kernel: the reference's mamba block runs ssd_reference in "
                             "plain jnp, differentiated by jax.value_and_grad; the Pallas ssd "
                             "kernel has no backward",
            "launches": train_mamba2["ssd_backward_launches"],
            "launches_zamba2_training": train_zamba2["ssd_backward_launches"],
            "launches_by_route": train_mamba2["ssd_backward_routes"],
            "launches_zamba2_training_by_route": train_zamba2["ssd_backward_routes"],
            "max_abs_err": ssd_bwd["max_rel_err"],
            "max_abs_err_note": "relative to each gradient's largest entry",
            "ms": ssd_bwd_timing["ms"],
            "device_ms": ssd_bwd_timing["device_ms"],
            "device_ms_behind_spin": ssd_bwd_timing["device_ms_behind_spin"],
            "device_kernels_ms": ssd_bwd_timing["device_kernels_ms"],
            "kernel_ms": ssd_bwd_timing["ms"],
            "cuda_core_device_ms": ssd_bwd_timing["cuda_core_device_ms"],
            "cuda_core_device_kernels_ms": ssd_bwd_timing["cuda_core_device_kernels_ms"],
            "plain_ms": ssd_bwd_timing["plain_ms"],
            "bound_ms": ssd_bwd_timing["bound_ms"],
            "bound_by": ssd_bwd_timing["bound_by"],
            "library_ms": None,
            "library_note": ssd_bwd_timing["library_note"],
            "shape": {k: ssd_bwd_timing[k] for k in ("B", "S", "H", "P", "N", "chunk", "dtype",
                                                     "route")},
        },
    ]}
    log(json.dumps(kernels))
    log(gpu_identity())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
