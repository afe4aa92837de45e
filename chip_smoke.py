#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that the
port starts on the GPU and that its main path runs through its kernels.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernel is built for sm_90a) and ``nvcc``;
it builds every kernel from the sources in ``src/repro_torch`` first.
Phases, each fatal on failure (a failure exits non-zero and prints no
final line):

1. the card's name and power limit; build the paged-attention kernel and
   print the compiler's register/shared-memory summary;
2. the kernel against its plain PyTorch version on the card: bf16, f32
   and int8 pages, MHA/GQA/MQA, softcap, windows, with and without the new
   token, at the reference's test shapes and at the serving path's shape;
   then kernel, plain-version and library (SDPA on densely gathered K/V)
   times at the serving path's shape, beside the least time the card
   could take for the same work;
3. the model on a small input: prefill and paged decode on the card
   (through the kernel) against the same model on the CPU (plain version);
4. the main path: ``qwen1.5-0.5b`` at full width with random weights
   from a seed, served by two engines behind ``MoriRouter.replay`` with
   the launcher's defaults; the kernel's launch count must equal
   layers x decode steps, and pages must move between the tiers.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the per-kernel JSON record and the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s
#: by the type of the operands
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

#: kernel-vs-plain bands, the reference's own (tests/test_kernels.py tol()
#: and tests/test_kv_quant.py EXACT_BAND): both sides compute in f32 from
#: identical operands, so what differs is summation order plus, for a bf16
#: output, one rounding of the result
ATOL = {"float32": 2e-3, "bfloat16": 2e-2}
#: model logits and pages, card (kernel) against CPU (plain version), bf16
#: weights: the band of tests/test_torch_model.py, one bf16 ulp at the
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


# ------------------------------------------------------------ phase 2
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
    """Every variant, kernel against plain version. Returns the largest
    error at the serving path's shape."""
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
    main_err = 0.0
    for name, shape, dtype, case_kw, attn_kw in cases:
        c = make_case(rng, shape, dtype, **case_kw)
        out = run_kernel(ops, c, **attn_kw)
        torch.cuda.synchronize()
        want = run_plain(ref, c, **attn_kw)
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        tol = ATOL[str(dtype).removeprefix("torch.")]
        ok = math.isfinite(err) and bool(
            (diff <= tol + tol * want.float().abs()).all())
        log(f"kernel case {name}: max_abs_err {err:.3e} (rtol=atol={tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged attention kernel disagrees on {name}")
        if name.startswith("main") and "int8=False" in name:
            main_err = err
    return main_err


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


def time_kernel(layers: int):
    """Kernel, plain version and SDPA at the serving path's shape, over
    ``layers`` distinct layer slices of the pool per call round (as one
    decode step walks the layers, so the pages do not sit in L2)."""
    from repro_torch.kernels.paged_attention import ops, ref

    rng = np.random.default_rng(1)
    c = make_case(rng, MAIN_SHAPE, torch.bfloat16, lengths=MAIN_LENGTHS,
                  layers=layers)
    B, H, KH, D, T, P = MAIN_SHAPE

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
    log(f"SDPA yardstick vs kernel at the main shape: max_abs_err {lib_err:.3e}")
    if not lib_err <= ATOL["bfloat16"] * (1 + kern_out.abs().max().item()):
        raise AssertionError("the SDPA yardstick computes another function")

    kernel_ms = time_call(kernel_round, 50) / layers
    plain_ms = time_call(plain_round, 5) / layers
    library_ms = time_call(library_round, 50) / layers

    # least time for one call: each needed input byte read once, the
    # output written once; the data decides what is needed (the visible
    # positions of each row, the new token from its operand)
    lengths = np.asarray(MAIN_LENGTHS)
    elem = 2
    kv_bytes = 2 * int((lengths - 1).sum()) * KH * D * elem
    io_bytes = (B * H * D + 2 * B * KH * D + B * H * D) * elem
    meta_bytes = 4 * (B * P + B)
    n_bytes = kv_bytes + io_bytes + meta_bytes
    n_ops = int(4 * H * D * lengths.sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=n_bytes, operations=n_ops)


# ------------------------------------------------------------ phase 3
def check_model_small():
    """Reduced qwen: prefill + paged decode on the card (kernel) against
    the CPU (plain version), same weights, teacher-forced tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    T, n_pages, ctx = 8, 16, 21
    tokens = torch.arange(2, 2 + ctx)[None, :] * 7 % cfg.vocab_size
    worst = 0.0
    outs = {}
    for dev in ("cpu", DEVICE):
        model = Model(cfg, {k: _to(v, dev) for k, v in params.items()})
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kp = torch.zeros((L, n_pages, T, KH, HD), dtype=torch.bfloat16, device=dev)
        vp = torch.zeros_like(kp)
        logits, cache = model.prefill({"tokens": tokens.to(dev)})
        n = -(-ctx // T)
        k_c = torch.nn.functional.pad(cache["k"][:, 0], (0, 0, 0, 0, 0, n * T - ctx))
        v_c = torch.nn.functional.pad(cache["v"][:, 0], (0, 0, 0, 0, 0, n * T - ctx))
        kp[:, :n] = k_c.reshape(L, n, T, KH, HD)
        vp[:, :n] = v_c.reshape(L, n, T, KH, HD)
        step_logits = [logits.float().cpu()]
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
    ok = True
    for a, b in zip(outs["cpu"], outs[DEVICE]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite values from the card")
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        ok &= bool((diff <= MODEL_ATOL + MODEL_RTOL * a.abs()).all())
    log(f"model on the card vs the CPU (reduced qwen, 6 decode steps): max_abs_err "
        f"{worst:.3e} (atol={MODEL_ATOL}, rtol={MODEL_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("model on the card disagrees with the CPU")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ------------------------------------------------------------ phase 4
def serve_full_width():
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve

    args = serve.parse_args([])          # the launcher's defaults: full width, cuda
    t0 = time.perf_counter()
    cfg, engines, router = serve.build_router(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    corpus = serve.corpus_for(args)
    ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = ops.KERNEL.launches
    engine_steps = sum(e.steps for e in engines)
    record = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "replicas": len(engines), "programs": len(corpus),
        "steps_completed": m.steps_completed, "tokens_generated": m.tokens_generated,
        "cached_tokens": m.cached_tokens, "prefilled_tokens": m.prefilled_tokens,
        "offloaded_pages": m.offloaded_pages, "reloaded_pages": m.reloaded_pages,
        "gated_events": m.gated_events, "pump_steps": m.pump_steps,
        "engine_steps": engine_steps, "kernel_launches": launches,
        "setup_s": setup_s, "replay_s": replay_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("serve " + json.dumps(record))
    if m.steps_completed <= 0:
        raise AssertionError("the replay completed no program step")
    if m.offloaded_pages + m.reloaded_pages <= 0:
        raise AssertionError("no page moved between the tiers")
    if launches != cfg.num_layers * engine_steps or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != layers {cfg.num_layers} x decode steps "
            f"{engine_steps}: decode did not go through the kernel")
    produced = [t for toks in router.output_log.values() for t in toks]
    if len(produced) != m.tokens_generated or not all(
            0 <= t < cfg.vocab_size for t in produced):
        raise AssertionError("generated tokens are missing or out of the vocabulary")
    return launches, engines


def decode_breakdown(engine, context: int = 200, steps: int = 20):
    """Where a full-width decode step's time goes: one engine with every
    slot decoding a ``context``-token request; host-clock time per step
    (ends in a synchronize), then a profiled window for the device's busy
    share and its kernel time by name. Runs after the main path, so its
    launches are not in the main path's count."""
    from repro_torch.serving import EngineRequest

    rng = np.random.default_rng(2)
    for i in range(engine.max_slots):
        engine.submit(EngineRequest(
            f"breakdown{i}", rng.integers(2, engine.cfg.vocab_size, context).tolist(),
            max_new_tokens=2 * steps + 10))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            engine.step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the CPU ops that launched them carry the
    # same time again as their own device total
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        "batch": engine.max_slots, "context": context, "step_ms": step_ms,
        "profiled_steps": 5, "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / window_us if window_us else None,
        "top_kernels_ms": {k[:60]: v / 1e3 for k, v in top},
        "paged_attention_ms": sum(v for k, v in kernels.items()
                                  if "paged_attention" in k) / 1e3,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    identity = gpu_identity()
    log(f"gpu: {identity}; torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    ops.KERNEL.load()
    log(f"built paged_attention in {time.perf_counter() - t0:.1f}s; ptxas:")
    for line in ops.KERNEL.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    main_err = check_kernel_cases()
    timing = time_kernel(layers=24)
    log("paged_attention timing " + json.dumps(timing))
    check_model_small()
    launches, engines = serve_full_width()
    log("decode breakdown " + json.dumps(decode_breakdown(engines[0])))

    kernels = {"kernels": [{
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:129",
        "replaces_function": "paged_attention",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": timing["ms"],
        "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}
    log(json.dumps(kernels))
    log(gpu_identity())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
