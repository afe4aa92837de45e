"""Two-tier paged KV storage: device pages + host pages.

The port's counterpart of ``repro/serving/kvpool.py``. Device K and V are
tensors ``[L, n_pages, page_tokens, KH, HD]`` on the pool's ``device``
(bf16, or int8 plus f32 ``[L, n_pages]`` scale sidecars); the trailing
(page_tokens, KH, HD) tile of one layer is what the paged-attention kernel
reads. Host pages are CPU tensors in the same layout, pinned when the
device is a GPU: bf16 pages are kept as they are (bit-exact round trips),
int8 pages with their scale sidecars.

The pool **is** the decode state: :meth:`block_table_view` hands the
device tensors to ``Model.decode_paged``, which appends each step's KV
into the tail pages in place. Every update here is in place
(``index_put_``/``copy_``) where the reference returned new arrays and
adopted them; copies between the tiers are synchronous ``copy_`` calls.

**Tier formats** (``repro_torch.kernels.kv_quant.PAGE_FORMATS``):
``offload_format`` is what host copies carry (``"bf16"`` raw, or
``"int8"`` quantized on offload); ``device_format="int8"`` packs the
resident pool too and requires ``offload_format="int8"``.
:attr:`page_bytes` and :attr:`host_page_bytes` are the only numbers
billing and tier budgets may use, and every verb that writes a page in a
given format reports the transition to KVSAN (``on_format``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.analysis import kvsan
from repro_torch.kernels import kv_quant


def _index(page_idx, device) -> torch.Tensor:
    return torch.as_tensor(page_idx, dtype=torch.long, device=device)


def _pad_run(k_tokens, v_tokens, n: int, page_tokens: int):
    """Zero-pad a token run ``[L, S, KH, HD]`` to ``n`` whole pages and
    split it into ``[L, n, T, KH, HD]``."""
    L, S, KH, HD = k_tokens.shape
    pad = n * page_tokens - S
    if pad:
        k_tokens = torch.nn.functional.pad(k_tokens, (0, 0, 0, 0, 0, pad))
        v_tokens = torch.nn.functional.pad(v_tokens, (0, 0, 0, 0, 0, pad))
    return (k_tokens.reshape(L, n, page_tokens, KH, HD),
            v_tokens.reshape(L, n, page_tokens, KH, HD))


def scatter_token_run(k_arr, v_arr, page_idx, k_tokens, v_tokens, page_tokens) -> None:
    """Scatter a token run ``[L, S, KH, HD]`` into pool pages in ONE
    in-place update. ``page_idx`` receives consecutive ``page_tokens``-sized
    chunks; a partial tail is zero-padded."""
    idx = _index(page_idx, k_arr.device)
    kc, vc = _pad_run(k_tokens, v_tokens, idx.shape[0], page_tokens)
    k_arr[:, idx] = kc.to(k_arr.dtype)
    v_arr[:, idx] = vc.to(v_arr.dtype)


def gather_token_run(k_arr, v_arr, page_idx):
    """Gather pages -> ``[L, n*page_tokens, KH, HD]``."""
    idx = _index(page_idx, k_arr.device)
    k = k_arr[:, idx]                                           # [L,n,t,KH,HD]
    v = v_arr[:, idx]
    L, n, t, KH, HD = k.shape
    return k.reshape(L, n * t, KH, HD), v.reshape(L, n * t, KH, HD)


def scatter_token_run_q(
    k_arr, k_scale, v_arr, v_scale, page_idx, k_tokens, v_tokens, page_tokens
) -> None:
    """Quantizing twin of :func:`scatter_token_run` for an int8-resident
    pool: each page of the run is quantized with its own scale, and
    payload and sidecars land in one update apiece."""
    idx = _index(page_idx, k_arr.device)
    kc, vc = _pad_run(k_tokens, v_tokens, idx.shape[0], page_tokens)
    kq, ks = kv_quant.quantize_pages(kc)
    vq, vs = kv_quant.quantize_pages(vc)
    k_arr[:, idx] = kq
    k_scale[:, idx] = ks
    v_arr[:, idx] = vq
    v_scale[:, idx] = vs


def gather_token_run_q(k_arr, k_scale, v_arr, v_scale, page_idx, dtype):
    """Dequantizing twin of :func:`gather_token_run`: returns
    ``[L, n*page_tokens, KH, HD]`` in the logical ``dtype``."""
    idx = _index(page_idx, k_arr.device)
    k = kv_quant.dequantize_pages(k_arr[:, idx], k_scale[:, idx], dtype)
    v = kv_quant.dequantize_pages(v_arr[:, idx], v_scale[:, idx], dtype)
    L, n, t, KH, HD = k.shape
    return k.reshape(L, n * t, KH, HD), v.reshape(L, n * t, KH, HD)


@dataclass
class PoolStats:
    device_free: int
    device_total: int
    host_free: int
    host_total: int
    offload_bytes: int = 0
    reload_bytes: int = 0


class PagePool:
    def __init__(
        self,
        *,
        layers: int,
        kv_heads: int,
        head_dim: int,
        page_tokens: int,
        n_device_pages: int,
        n_host_pages: int,
        device,
        offload_format: str = "bf16",
        device_format: str = "bf16",
    ):
        self.layers = layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.page_tokens = page_tokens
        self.device = torch.device(device)
        self.dtype = torch.bfloat16    # the logical (dequantized) dtype
        self.offload_format = kv_quant.check_format(offload_format)
        self.device_format = kv_quant.check_format(device_format)
        if self.device_format == "int8" and self.offload_format != "int8":
            raise ValueError(
                "device_format='int8' requires offload_format='int8': a "
                "quantized resident page carries no extra bits a bf16 host "
                "copy could preserve"
            )
        self.quantized_device = self.device_format == "int8"
        dev = self.device
        shape = (layers, n_device_pages, page_tokens, kv_heads, head_dim)
        if self.quantized_device:
            self.k = torch.zeros(shape, dtype=torch.int8, device=dev)
            self.v = torch.zeros(shape, dtype=torch.int8, device=dev)
            # per-(layer, page) fp32 scale sidecars; 1.0 on a zero page is
            # as good as any scale (payload 0 dequantizes to 0)
            self.k_scale = torch.ones((layers, n_device_pages), dtype=torch.float32, device=dev)
            self.v_scale = torch.ones((layers, n_device_pages), dtype=torch.float32, device=dev)
        else:
            self.k = torch.zeros(shape, dtype=self.dtype, device=dev)
            self.v = torch.zeros(shape, dtype=self.dtype, device=dev)
            self.k_scale = None
            self.v_scale = None
        hshape = (layers, n_host_pages, page_tokens, kv_heads, head_dim)
        # pinned host memory only exists alongside a GPU
        pin = dev.type == "cuda"

        def host(shape_, dtype_, fill=0.0):
            return torch.full(shape_, fill, dtype=dtype_, pin_memory=pin)

        if self.offload_format == "int8":
            self.host_k = host(hshape, torch.int8)
            self.host_v = host(hshape, torch.int8)
            self.host_k_scale = host((layers, n_host_pages), torch.float32, 1.0)
            self.host_v_scale = host((layers, n_host_pages), torch.float32, 1.0)
        else:
            self.host_k = host(hshape, self.dtype)
            self.host_v = host(hshape, self.dtype)
            self.host_k_scale = None
            self.host_v_scale = None
        self._free_dev = list(range(n_device_pages))
        self._free_host = list(range(n_host_pages))
        self.n_device_pages = n_device_pages
        self.n_host_pages = n_host_pages
        self.offload_bytes = 0
        self.reload_bytes = 0
        # page-lifetime sanitizer (None unless REPRO_KVSAN=1): every
        # alloc/free/read/write verb below reports to it
        self._san = kvsan.maybe_sanitizer(
            n_device_pages=n_device_pages,
            n_host_pages=n_host_pages,
            page_tokens=page_tokens,
        )
        if self._san is not None:
            self._san.pool = self

    @property
    def page_bytes(self) -> int:
        """Device-resident bytes per page (in :attr:`device_format`) —
        the number device budgets are priced in."""
        return kv_quant.page_wire_bytes(
            self.layers, self.page_tokens, self.kv_heads, self.head_dim,
            self.device_format,
        )

    @property
    def host_page_bytes(self) -> int:
        """Bytes per page as moved/held on host tiers (in
        :attr:`offload_format`) — the number every transfer and host
        budget is priced in."""
        return kv_quant.page_wire_bytes(
            self.layers, self.page_tokens, self.kv_heads, self.head_dim,
            self.offload_format,
        )

    def _fmt_event(self, tier: str, page: int, fmt: str) -> None:
        if self._san is not None:
            self._san.on_format(tier, page, fmt)

    # ---------------------------------------------------------- allocation
    def device_free_count(self) -> int:
        return len(self._free_dev)

    def host_free_count(self) -> int:
        return len(self._free_host)

    def alloc_device(self) -> int | None:
        page = self._free_dev.pop() if self._free_dev else None
        if page is not None and self._san is not None:
            self._san.on_alloc("dev", page)
        return page

    def alloc_host(self) -> int | None:
        page = self._free_host.pop() if self._free_host else None
        if page is not None and self._san is not None:
            self._san.on_alloc("host", page)
        return page

    def free_device(self, page: int) -> None:
        if self._san is not None:
            self._san.on_free("dev", page)
        self._free_dev.append(page)

    def free_host(self, page: int) -> None:
        if self._san is not None:
            self._san.on_free("host", page)
        self._free_host.append(page)

    # -------------------------------------------------------------- writes
    def block_table_view(self):
        """The pool's device tensors ``(k, v)``, each
        ``[L, n_pages, page_tokens, KH, HD]`` — the operand the block-table
        decode path reads and appends to in place. On an int8-resident
        pool they are the quantized payload; :meth:`scale_view` hands out
        the sidecars."""
        return self.k, self.v

    def scale_view(self):
        """The per-(layer, page) fp32 scale sidecars ``(k_scale, v_scale)``
        on an int8-resident pool; ``(None, None)`` on a bf16 pool."""
        return self.k_scale, self.v_scale

    def adopt(self, k, v, k_scale=None, v_scale=None) -> None:
        """Install replacement page tensors (same shapes, dtypes and
        device). The engine's decode step updates the pool in place and
        needs no adopt; this serves callers that built new tensors. Page
        ids are stable across adopt, so host copies, free lists and
        in-flight transfer staging stay valid."""
        for new, old in ((k, self.k), (v, self.v)):
            if new.shape != old.shape or new.dtype != old.dtype or new.device != old.device:
                raise ValueError("adopt() needs tensors like the pool's own")
        self.k, self.v = k, v
        if self.quantized_device:
            if k_scale is None or v_scale is None or k_scale.shape != self.k_scale.shape:
                raise ValueError("int8-resident pool: adopt() needs the scale sidecars")
            self.k_scale, self.v_scale = k_scale, v_scale

    def write_device_pages(self, pages: list[int], k_tokens, v_tokens) -> None:
        """Write a token run spanning several pages in ONE scatter.

        k_tokens/v_tokens: ``[L, S, KH, HD]`` with the run starting at a
        page boundary; ``pages`` receive consecutive ``page_tokens``-sized
        chunks (the last may be partial — it is zero-padded).
        """
        if not pages:
            return
        if self._san is not None:
            for page in pages:
                self._san.on_write("dev", page)
                self._san.on_format("dev", page, self.device_format)
        if self.quantized_device:
            scatter_token_run_q(
                self.k, self.k_scale, self.v, self.v_scale,
                pages, k_tokens, v_tokens, self.page_tokens,
            )
            return
        scatter_token_run(self.k, self.v, pages, k_tokens, v_tokens, self.page_tokens)

    def read_device_pages(self, pages: list[int]):
        """Gather pages -> [L, n*page_tokens, KH, HD], dequantized to the
        logical dtype on an int8 pool."""
        if self._san is not None:
            for page in pages:
                self._san.on_read("dev", page)
        if self.quantized_device:
            return gather_token_run_q(
                self.k, self.k_scale, self.v, self.v_scale, pages, self.dtype
            )
        return gather_token_run(self.k, self.v, pages)

    # ----------------------------------------------------------- transfers
    def copy_page_to_host(self, dev_page: int) -> int | None:
        """Stage one device page into a host page *without* freeing the
        device copy — the streamed-offload primitive: the source stays
        valid until the whole transfer commits, so a mid-stream
        CancelTransfer is a pure rollback of host pages.

        The host copy carries :attr:`offload_format`: bf16 copies the
        bits, int8 quantizes on the device before the copy (or, from an
        int8-resident pool, copies payload + scales verbatim).

        Deliberately does NOT bill ``offload_bytes``: staging is
        speculative; the committing caller bills via :meth:`bill_offload`."""
        if self._san is not None:
            self._san.on_read("dev", dev_page)
        hp = self.alloc_host()
        if hp is None:
            return None
        if self._san is not None:
            self._san.on_write("host", hp)
        self._fmt_event("host", hp, self.offload_format)
        if self.offload_format == "int8":
            if self.quantized_device:
                kq, ks = self.k[:, dev_page], self.k_scale[:, dev_page]
                vq, vs = self.v[:, dev_page], self.v_scale[:, dev_page]
            else:
                kq, ks = kv_quant.quantize_pages(self.k[:, dev_page])
                vq, vs = kv_quant.quantize_pages(self.v[:, dev_page])
            self.host_k_scale[:, hp].copy_(ks)
            self.host_v_scale[:, hp].copy_(vs)
        else:
            kq, vq = self.k[:, dev_page], self.v[:, dev_page]
        self.host_k[:, hp].copy_(kq)
        self.host_v[:, hp].copy_(vq)
        return hp

    def copy_page_to_device(self, host_page: int) -> int | None:
        """Stage one host page into a device page *without* freeing the
        host copy (streamed-reload primitive). An int8 host page lands
        verbatim on an int8-resident pool and dequantizes to the logical
        dtype on a bf16 pool."""
        if self._san is not None:
            self._san.on_read("host", host_page)
        dp = self.alloc_device()
        if dp is None:
            return None
        if self._san is not None:
            self._san.on_write("dev", dp)
        self._fmt_event("dev", dp, self.device_format)
        hk, hv = self.host_k[:, host_page], self.host_v[:, host_page]
        if self.offload_format == "int8":
            hks, hvs = self.host_k_scale[:, host_page], self.host_v_scale[:, host_page]
            if self.quantized_device:
                self.k_scale[:, dp].copy_(hks)
                self.v_scale[:, dp].copy_(hvs)
            else:
                dev = self.device
                self.k[:, dp] = kv_quant.dequantize_pages(
                    hk.to(dev), hks.to(dev), self.k.dtype)
                self.v[:, dp] = kv_quant.dequantize_pages(
                    hv.to(dev), hvs.to(dev), self.v.dtype)
                return dp
        self.k[:, dp].copy_(hk)
        self.v[:, dp].copy_(hv)
        return dp

    def import_host_page(self, src_pool: "PagePool", src_hp: int) -> int | None:
        """Copy one host page from *another replica's* pool into this pool's
        host tier — the cross-replica migrate primitive. The copy is
        format-verbatim (bf16 bits, or int8 payload + scale sidecar), so
        the destination KV is byte-identical to the source; it is
        copy-without-free and unbilled, like the staging verbs above."""
        same_geometry = (
            self.host_k.shape[0] == src_pool.host_k.shape[0]
            and self.host_k.shape[2:] == src_pool.host_k.shape[2:]
            and self.host_k.dtype == src_pool.host_k.dtype
            and self.offload_format == src_pool.offload_format
        )
        if not same_geometry:
            raise ValueError("incompatible page geometry across replicas")
        if src_pool._san is not None:
            src_pool._san.on_read("host", src_hp)
        hp = self.alloc_host()
        if hp is None:
            return None
        if self._san is not None:
            self._san.on_write("host", hp)
        self._fmt_event("host", hp, self.offload_format)
        self.host_k[:, hp].copy_(src_pool.host_k[:, src_hp])
        self.host_v[:, hp].copy_(src_pool.host_v[:, src_hp])
        if self.offload_format == "int8":
            self.host_k_scale[:, hp].copy_(src_pool.host_k_scale[:, src_hp])
            self.host_v_scale[:, hp].copy_(src_pool.host_v_scale[:, src_hp])
        return hp

    def bill_offload(self, pages: int = 1) -> None:
        """Record ``pages`` worth of committed device→host movement, at
        the offload format's wire size."""
        self.offload_bytes += pages * self.host_page_bytes

    def bill_reload(self, pages: int = 1) -> None:
        """Record ``pages`` worth of committed host→device movement, at
        the offload format's wire size (the wire carries the host copy)."""
        self.reload_bytes += pages * self.host_page_bytes

    def offload_page(self, dev_page: int) -> int | None:
        """Device -> host (atomic copy+free). Returns host page id."""
        hp = self.copy_page_to_host(dev_page)
        if hp is None:
            return None
        self.free_device(dev_page)
        self.bill_offload()
        return hp

    def reload_page(self, host_page: int) -> int | None:
        """Host -> device (atomic copy+free). Returns device page id."""
        dp = self.copy_page_to_device(host_page)
        if dp is None:
            return None
        self.free_host(host_page)
        self.bill_reload()
        return dp

    def stats(self) -> PoolStats:
        return PoolStats(
            device_free=len(self._free_dev),
            device_total=self.n_device_pages,
            host_free=len(self._free_host),
            host_total=self.n_host_pages,
            offload_bytes=self.offload_bytes,
            reload_bytes=self.reload_bytes,
        )
