"""Public entry point of the Mamba-2 SSD scan.

The wrapper chooses by the tensors' device, with no flag: CUDA tensors
launch the Hopper kernel (``csrc/ssd.cu``) or raise; CPU tensors take the
plain PyTorch version, ``ssd_reference``, and autograd runs through it as
through any PyTorch code. There is no fallback from the kernel to the
plain version.

Gradients on the card: a CUDA call that autograd records (grad enabled,
an operand that requires grad) goes through :class:`_SsdFn`, whose
forward launches the forward kernel on the route ``_route`` picks and
whose backward launches the backward kernel (``csrc/ssd_bwd.cu``; plain
versions ``ref.ssd_bwd_ref`` and, pass for pass,
``ref.ssd_backward_passes_ref``). The backward recomputes the states from
the forward's operands, so both forward routes feed it alike; it takes
f32 or bf16, P and N up to 256 and chunks whose working set fits a
block's shared memory (chunk 256 at P = N = 256), and refuses the rest
before the forward runs (ROADMAP). It has two routes of its own, chosen
by ``_bwd_route`` from dtypes, shapes and alignment alone:
``tensor_core`` (bf16 x, dy, B and C, P and N multiples of 16 up to 256,
a chunk that is a multiple of 64 up to 256, 16-byte aligned rows, and a
working set within a block's shared memory, ``_bwd_tc_smem``: the
``mma.sync`` passes, with the operands they compute in f32 as hi + lo
bf16 pairs; plain version ``ref.ssd_backward_passes_ref(split_operands=
True)``) and ``cuda_core`` (everything else: the first version's f32
passes). ``KERNEL.backward_launches`` counts its launches and
``KERNEL.backward_kernel.routes`` them by route; serving runs under
``torch.no_grad()`` and never reaches it.

``ssd(x, dt, A, Bm, Cm, chunk=128)`` is the counterpart of
``repro.kernels.ssd``: x ``[B, S, H, P]``, dt ``[B, S, H]`` f32 (after
softplus), A ``[H]`` f32, and a single B/C group as ``[B, S, N]`` or
``[B, S, 1, N]``. Returns y ``[B, S, H, P]`` in x's dtype and the final
state ``[B, H, P, N]`` f32. Unlike the Pallas kernel, S need not be a
multiple of ``chunk``: the tail is masked as the plain version pads it.
Inputs may be strided views (the model passes slices of its fused
projection) as long as their last dimension is contiguous.

Two routes inside the kernel library, chosen by dtype and shape alone
(``_route``), never on a failure:

- ``tensor_core``: bf16 x and B/C, ``P`` and ``N`` multiples of 16, a
  chunk that is a multiple of 64, none of them above 256, and 16-byte
  aligned rows. Three passes launched by one C call (``ssd_scan``): a chunk
  pass, parallel over (row, chunk, head, column range of N), writes each
  chunk's ``cum`` and state to an f32 workspace; a state pass, elementwise
  over (row, head, P·N) and serial over chunks, carries the state (skipped
  for a one-chunk sequence); an output pass, parallel over (row, chunk,
  head, row tile, column range of P), writes y. ``_scan_plan`` sizes the
  grid from the shapes and the card's SM count, never from device data,
  so a call needs no device-to-host sync. ``ref.ssd_chunked_passes_ref``
  is the same decomposition in plain PyTorch.
- ``cuda_core``: everything else (f32 or mixed dtypes, other widths or
  chunks, unaligned rows): the first port's one-pass f32 kernel.

``KERNEL.launches`` counts forward launches, one per call whatever the
route (a recording call's too); ``KERNEL.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.ssd import _build
from repro_torch.kernels.ssd.ref import ssd_reference

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"cuda_core": 0, "tensor_core": 1}
#: shared memory a block may use on Hopper (bytes)
_SMEM_LIMIT = 232448
#: chunk rows an output-pass block covers (4 warps of 16 rows)
ROW_TILE = 64
#: the widest column range of P an output-pass block holds in registers,
#: and of N a chunk-pass block stages: at 64 columns of N the chunk pass
#: needs ~56 KB of shared memory at mamba2's shape, four blocks an SM,
#: which the card ran faster than one range of 128 at every S measured
_MAX_RANGE = 64
#: the largest P, N and chunk the tensor-core route takes: within them both
#: passes' shared memory (``csrc/ssd.cu``, ``tc_*_smem``) stays under
#: ``_SMEM_LIMIT`` (~211 KB at the most)
_MAX_WIDTH = 256


class ScanPlan(NamedTuple):
    """The tensor-core route's grid: ``state_splits`` column ranges of N a
    (row, chunk, head) in the chunk pass, ``p_splits`` column ranges of P
    a (row, chunk, head, row tile) in the output pass, and the blocks each
    pass runs (the output pass's live ones: row tiles past S exit)."""
    chunks: int
    row_tiles: int
    state_splits: int
    p_splits: int
    state_blocks: int
    output_blocks: int


def _splits(width: int, most: int) -> list[int]:
    """Ways to cut ``width`` into equal ranges that are multiples of 16 and
    no wider than ``most``, fewest first."""
    return [s for s in (1, 2, 4, 8) if width % (16 * s) == 0 and width // s <= most]


def _scan_plan(Bsz: int, S: int, H: int, P: int, N: int, Q: int, n_sm: int) -> ScanPlan:
    """Cut the tensor-core route's work so each pass fills ``n_sm`` SMs: the
    fewest column splits, into ranges of at most ``_MAX_RANGE`` columns,
    that give every SM a block, or the most there are. A one-chunk prefill
    of mamba2 (80 heads) gets 160 blocks in both passes. Reads host
    integers only."""
    chunks = -(-S // Q)
    row_tiles = Q // ROW_TILE
    live_tiles = (chunks - 1) * row_tiles + -(-(S - (chunks - 1) * Q) // ROW_TILE)

    def fewest(cands, blocks_per_split):
        return next((s for s in cands if blocks_per_split * s >= n_sm), cands[-1])

    state_splits = fewest(_splits(N, _MAX_RANGE), Bsz * chunks * H)
    p_splits = fewest(_splits(P, _MAX_RANGE), Bsz * H * live_tiles)
    return ScanPlan(chunks, row_tiles, state_splits, p_splits,
                    Bsz * chunks * H * state_splits, Bsz * H * live_tiles * p_splits)


def _workspace_bytes(Bsz: int, H: int, P: int, N: int, Q: int, chunks: int) -> int:
    """f32 ``cum [B, chunks, H, Q]`` and the states after every chunk but the
    last ``[B, chunks - 1, H, P, N]``."""
    return 4 * (Bsz * chunks * H * Q + Bsz * (chunks - 1) * H * P * N)


def _bwd_workspace_bytes(Bsz: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """The backward's f32 workspace: ``cum [B, chunks, H, Q]``, the states
    and their gradients ``[B, chunks, H, P, N]`` each, a head's dB and dC
    ``[B, S, H, N]`` each, and a (row, chunk, head)'s dA."""
    chunks = -(-S // Q)
    return 4 * (Bsz * chunks * H * (Q + 2 * P * N + 1) + 2 * Bsz * S * H * N)


def _bwd_tc_smem(P: int, N: int, Q: int) -> int:
    """Shared memory of the backward's largest tensor-core block, in bytes
    (``tc_smem`` in ``csrc/ssd_bwd.cu``): the gradient pass holds the
    chunk's C, B, x and dy rows and a state as hi + lo pairs (rows padded by
    8 elements) and seven f32 vectors of Q; the chunk pass x or dy and the
    hi + lo weighted rows of its column range of N."""
    nw = next(w for w in (64, 48, 32, 16) if N % w == 0)
    grad = 2 * (2 * Q * (N + 8) + 2 * Q * (P + 8) + 2 * P * (N + 8)) + 4 * (7 * Q + 8)
    chunk = 2 * (Q * (P + 8) + 2 * Q * (nw + 8)) + 8 * Q
    return max(grad, chunk)


def _bwd_route(x, dy, Bm, Cm, chunk: int) -> str:
    """The backward's route, from dtypes, shapes and alignment alone, never
    on a failure: ``tensor_core`` for bf16 x, dy, B and C, P and N
    multiples of 16 up to 256, a chunk that is a multiple of 64 up to 256,
    16-byte aligned rows and a working set that fits a block's shared
    memory; ``cuda_core`` for everything else. At mamba2's and zamba2's
    training shapes the slices of the fused projection take the tensor
    cores."""
    P, N = x.shape[-1], Bm.shape[-1]
    if (all(t.dtype == torch.bfloat16 for t in (x, dy, Bm, Cm))
            and P % 16 == 0 and N % 16 == 0 and max(P, N) <= _MAX_WIDTH
            and chunk % 64 == 0 and chunk <= _MAX_WIDTH
            and _bwd_tc_smem(P, N, chunk) <= _SMEM_LIMIT
            and all(_nvcc.aligned(t) for t in (x, dy, Bm, Cm))):
        return "tensor_core"
    return "cuda_core"


def _route(x, Bm, Cm, chunk: int, n_sm: int) -> tuple[str, ScanPlan | None]:
    """Which kernel a call launches, from dtypes and shapes alone, and the
    tensor-core route's plan where it takes that route."""
    (Bsz, S, H, P), N = x.shape, Bm.shape[-1]
    if (x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
            and chunk % ROW_TILE == 0 and max(P, N, chunk) <= _MAX_WIDTH
            and _splits(P, _MAX_RANGE) and _splits(N, _MAX_RANGE)
            and _nvcc.aligned(x) and _nvcc.aligned(Bm) and _nvcc.aligned(Cm)):
        return "tensor_core", _scan_plan(Bsz, S, H, P, N, chunk, n_sm)
    return "cuda_core", None


def _check_operands(x, dt, A, Bm, Cm, chunk: int) -> None:
    """The kernels' operands: shapes, devices, dtypes and unit last strides."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(
            f"want x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,N]; got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}"
        )
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or tuple(Cm.shape) != (Bsz, S, N)):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}"
        )
    dev = x.device
    for name, t in {"dt": dt, "A": A, "B": Bm, "C": Cm}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    if x.stride(-1) != 1:
        raise ValueError("x must be contiguous in its last dimension")
    if x.dtype not in _DTYPE_CODES or Bm.dtype not in _DTYPE_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"x and B/C must be float32 or bfloat16 (B and C alike), "
                        f"not {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, not {dt.dtype}, {A.dtype}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, not {chunk}")


class SsdKernel(_nvcc.Kernel):
    """The CUDA kernel behind the wrapper (see :class:`_nvcc.Kernel`)."""

    def __init__(self):
        super().__init__(_build.load, routes=_ROUTE_CODES)
        self._n_sm: dict[int, int] = {}
        #: the backward kernel, its own build; its ``launches`` counts the
        #: backward's launches (``backward_launches``)
        self.backward_kernel = _nvcc.Kernel(_build.load_bwd, routes=_ROUTE_CODES)

    @property
    def backward_launches(self) -> int:
        return self.backward_kernel.launches

    @backward_launches.setter
    def backward_launches(self, n: int) -> None:
        self.backward_kernel.launches = n

    def sm_count(self, dev: torch.device) -> int:
        """The card's SM count, read once per device."""
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in self._n_sm:
            self._n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        return self._n_sm[idx]

    def __call__(self, x, dt, A, Bm, Cm, *, chunk: int, route: str | None = None):
        """Launch the scan. ``route`` forces a route (for timing both on one
        input); ``None`` takes the one ``_route`` chooses."""
        _check_operands(x, dt, A, Bm, Cm, chunk)
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        dev = x.device
        if route not in (None, *_ROUTE_CODES):
            raise ValueError(f"route must be one of {list(_ROUTE_CODES)}, not {route!r}")
        chosen, plan = _route(x, Bm, Cm, chunk, self.sm_count(dev))
        if route == "tensor_core" and chosen != "tensor_core":
            raise ValueError("these dtypes, shapes or strides cannot take the tensor-core route")
        route = route or chosen
        lib = self.load()
        if route == "cuda_core":
            smem = lib.ssd_smem(P, N, chunk)
            if smem > _SMEM_LIMIT:
                raise ValueError(f"P={P}, N={N}, chunk={chunk} need {smem} B of shared memory, "
                                 f"more than {_SMEM_LIMIT}")
            ws, splits = None, (0, 0)
        else:
            ws = torch.empty(_workspace_bytes(Bsz, H, P, N, chunk, plan.chunks),
                             dtype=torch.uint8, device=dev)
            splits = (plan.state_splits, plan.p_splits)
        y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
        final_state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), final_state.data_ptr(), ws.data_ptr() if ws is not None else None,
                Bsz, S, H, P, N, chunk, _DTYPE_CODES[x.dtype], _DTYPE_CODES[Bm.dtype],
                x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
                Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                _ROUTE_CODES[route], *splits,
                stream,
            )
        _nvcc.check_status(err, "ssd_scan")
        self.launches += 1
        self.routes[route] += 1
        return y, final_state

    def refuse_backward(self, x, Bm, Cm, chunk: int, route: str | None = None) -> str:
        """Raise where the backward kernel cannot take these operands: the
        route's largest block must fit a block's shared memory (the
        tensor-core route's always does, ``_bwd_route``). ``route`` None
        takes the one ``_bwd_route`` chooses, with the output's gradient,
        not yet known before the forward, taken to be like x. Returns the
        route."""
        P, N = x.shape[-1], Bm.shape[-1]
        route = route or _bwd_route(x, x, Bm, Cm, chunk)
        smem = self.backward_kernel.load().ssd_bwd_smem(P, N, chunk, _ROUTE_CODES[route])
        if smem > _SMEM_LIMIT:
            raise NotImplementedError(
                f"the SSD backward kernel takes no P={P}, N={N}, chunk={chunk}: they need "
                f"{smem} B of shared memory a block, more than {_SMEM_LIMIT} (ROADMAP, kernel "
                "work on the SSD backward)")
        return route

    def backward(self, x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk: int,
                 route: str | None = None):
        """dx, ddt, dA, dB, dC of the scan on ``x, dt, A, Bm, Cm`` given the
        output's gradient ``dy`` and the final state's ``dfinal`` (None: not
        used); dx in x's type, dB and dC in B's, ddt and dA f32, each
        contiguous in its operand's shape. ``route`` forces a route (for
        timing both on one input); ``None`` takes the one ``_bwd_route``
        chooses."""
        _check_operands(x, dt, A, Bm, Cm, chunk)
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        dev = x.device
        if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
            raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match the output "
                             f"{tuple(x.shape)} {x.dtype}")
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dfinal is not None:
            if tuple(dfinal.shape) != (Bsz, H, P, N) or dfinal.device != dev:
                raise ValueError(f"dfinal must be [{Bsz}, {H}, {P}, {N}] on {dev}, not "
                                 f"{tuple(dfinal.shape)} on {dfinal.device}")
            dfinal = dfinal.to(torch.float32).contiguous()
            if dfinal.data_ptr() % 16:   # the tensor-core route reads it in float4
                dfinal = dfinal.clone()
        if route not in (None, *_ROUTE_CODES):
            raise ValueError(f"route must be one of {list(_ROUTE_CODES)}, not {route!r}")
        chosen = _bwd_route(x, dy, Bm, Cm, chunk)
        if route == "tensor_core" and chosen != "tensor_core":
            raise ValueError("these dtypes, shapes or strides cannot take the backward's "
                             "tensor-core route")
        route = self.refuse_backward(x, Bm, Cm, chunk, route or chosen)
        lib = self.backward_kernel.load()
        dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
        ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
        dA = torch.empty((H,), dtype=torch.float32, device=dev)
        dB = torch.empty((Bsz, S, N), dtype=Bm.dtype, device=dev)
        dC = torch.empty((Bsz, S, N), dtype=Cm.dtype, device=dev)
        ws = torch.empty(_bwd_workspace_bytes(Bsz, S, H, P, N, chunk), dtype=torch.uint8,
                         device=dev)
        strides = [x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
                   Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                   dy.stride(0), dy.stride(1), dy.stride(2)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ssd_bwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                dy.data_ptr(), dfinal.data_ptr() if dfinal is not None else None,
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                ws.data_ptr(), Bsz, S, H, P, N, chunk, _DTYPE_CODES[x.dtype],
                _DTYPE_CODES[Bm.dtype], (ctypes.c_longlong * len(strides))(*strides),
                _ROUTE_CODES[route], stream,
            )
        _nvcc.check_status(err, "ssd_bwd")
        self.backward_launches += 1
        self.backward_kernel.routes[route] += 1
        return dx, ddt, dA, dB, dC


#: the one kernel instance the wrapper launches; its ``launches`` is the
#: count a run reads to show that prefill went through the kernel
KERNEL = SsdKernel()


class _SsdFn(torch.autograd.Function):
    """The kernel under autograd: the forward launches the forward kernel
    and keeps its operands; the backward launches the backward kernel,
    which recomputes what it needs from them. A final state that is not
    used (training uses none) gets no cotangent: ``None``, not zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        y, final_state = KERNEL(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y, final_state

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC = KERNEL.backward(x, dt, A, Bm, Cm, dy, dfinal, chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, None


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Mamba-2 SSD scan. x [B,S,H,P]; B/C [B,S,N] or [B,S,1,N] (one group)."""
    if Bm.dim() == 4:
        if Bm.shape[2] != 1 or Cm.shape[2] != 1:
            raise ValueError("ssd takes a single B/C group")
        Bm, Cm = Bm[:, :, 0, :], Cm[:, :, 0, :]
    if x.is_cuda:
        if _nvcc.records_grad(x, dt, A, Bm, Cm):
            KERNEL.refuse_backward(x, Bm, Cm, chunk)
            return _SsdFn.apply(x, dt, A, Bm, Cm, chunk)
        return KERNEL(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_reference(x, dt, A, Bm[:, :, None, :], Cm[:, :, None, :], chunk=chunk)
