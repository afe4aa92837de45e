"""Model assembly of the port: describe / prefill / paged decode for the
dense, non-alternating family.

The counterpart of ``repro/models/model.py``. :class:`Model` is an
``nn.Module`` whose buffers are the parameter tree, leaf name for leaf
name (``blocks.attn.wq`` holds the stacked ``[L, d, H*hd]`` weight).
PyTorch runs eagerly: the reference's ``lax.scan`` over stacked layers is
a Python loop over the layer index, and its functional pool update under
donation is an in-place ``index_put_`` on the pool tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import kv_quant
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_dense_block,
    apply_dense_block_paged,
    describe_dense_block,
    rmsnorm,
    softcap,
    stack,
)
from repro_torch.models.params import Leaf, flatten_tree, leaves

F32 = torch.float32


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.local_global_alternating:
        raise NotImplementedError(
            f"the port serves the dense, non-alternating family; "
            f"{cfg.name} is {cfg.family}"
            + (" with local/global alternation" if cfg.local_global_alternating else "")
        )


class _ParamTree(nn.Module):
    """One level of the parameter tree: tensors are buffers, sub-dicts are
    child modules. ``p["wq"]`` and ``"bq" in p`` read like the reference's
    dict access, so the layer functions take either."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, node in tree.items():
            if isinstance(node, dict):
                self.add_module(key, _ParamTree(node))
            else:
                self.register_buffer(key, node)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._buffers or key in self._modules


def _layer_view(tree: dict, l: int) -> dict:
    """Layer ``l``'s slice of a stacked tree (views, no copies)."""
    return {
        k: _layer_view(v, l) if isinstance(v, dict) else v[l]
        for k, v in tree.items()
    }


class Model(nn.Module):
    """The model for one :class:`ModelConfig`. ``Model(cfg)`` only
    describes; ``Model(cfg, params)`` holds ``params`` (a nested dict of
    tensors from :func:`~repro_torch.models.params.materialize` or
    :func:`~repro_torch.models.params.load_jax_params`) without copying
    them, so replicas built from one dict share one set of weights."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.params = None
        if params is not None:
            want = {n: tuple(l.shape) for n, l in leaves(self.describe())}
            got = {n: tuple(t.shape) for n, t in flatten_tree(params)}
            if want != got:
                raise ValueError(f"parameter tree mismatch: want {want}, got {got}")
            self.params = _ParamTree(params)
            self._layers = [
                _layer_view(params["blocks"], l) for l in range(cfg.num_layers)
            ]

    # ------------------------------------------------------------ describe
    def describe(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        return {
            "embed": Leaf((v, d), ("vocab", "embed"), scale=0.02),
            "ln_f": Leaf((d,), ("embed_act",), init="zeros"),
            "head": Leaf((d, v), ("embed", "vocab")),
            "blocks": stack(describe_dense_block(cfg), cfg.num_layers),
        }

    def _logits(self, h):
        p = self.params
        h = rmsnorm(h, p.ln_f)
        return softcap((h @ p.head).to(F32), self.cfg.final_logit_softcap)

    # ------------------------------------------------------- sequence mode
    def sequence(self, x, positions, prefix=None, prefix_valid=None):
        """Run the full stack over a token-embedded sequence ``x`` [B,S,d].

        ``prefix``: optional {"k","v"} [L,B,Sp,KH,HD] radix-cached KV for
        chunked prefill. ``prefix_valid`` marks how many prefix positions
        are real when the prefix is padded to a bucket. Returns
        ``(hidden, cache)`` with cache {"k","v"} [L,B,S,KH,HD].
        """
        cfg = self.cfg
        ks, vs = [], []
        for l, p in enumerate(self._layers):
            pre = (prefix["k"][l], prefix["v"][l]) if prefix is not None else None
            x, (k, v) = apply_dense_block(
                p, x, cfg, positions=positions, window=cfg.sliding_window,
                prefix=pre, prefix_valid=prefix_valid,
            )
            ks.append(k)
            vs.append(v)
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, batch: dict, prefix=None, logit_index=None,
                positions_offset=None, prefix_valid=None):
        """Full- or suffix-context forward; returns ``(logits, cache)``.

        With ``prefix`` (stacked radix-cached KV), this is chunked prefill:
        only ``batch["tokens"]`` (the suffix) is computed, attending over
        prefix+suffix; the returned cache covers the suffix only.
        ``logit_index`` names the token position whose logits to return
        (default: the last). ``positions_offset``/``prefix_valid`` support
        a prefix padded past its real length: the first is the real
        absolute position of the first suffix token (RoPE uses true
        positions), the second masks the padded prefix tail.
        """
        tokens = batch["tokens"]
        x = self.params.embed[tokens]
        S = x.shape[1]
        q_off = 0 if prefix is None else prefix["k"].shape[2]
        pos0 = q_off if positions_offset is None else positions_offset
        positions = pos0 + torch.arange(S, device=x.device)[None, :]
        h, cache = self.sequence(x, positions, prefix=prefix, prefix_valid=prefix_valid)
        idx = -1 if logit_index is None else logit_index
        return self._logits(h[:, idx, :]), cache

    # ------------------------------------------------------- paged decode
    @torch.no_grad()
    def decode_paged(
        self, k_pages, v_pages, tokens, lengths, block_tables,
        tail_pages, tail_offsets, k_scales=None, v_scales=None,
    ):
        """One block-table decode step over the pool's tensors.

        ``k_pages``/``v_pages`` ``[L, N, T, KH, HD]`` are the serving
        engine's ``PagePool`` tensors; each sequence reads its context
        through ``block_tables`` ``[B, P]``. The new token's KV (global
        position ``lengths[b] - 1``) is carried out of the layer loop and
        written at ``(tail_pages[b], tail_offsets[b])`` for all layers in
        ONE ``index_put_`` after the loop — in place, where the reference
        returned new arrays under donation. On an int8-resident pool pass
        the ``[L, N]`` scale sidecars: each layer's slice feeds the
        kernel's dequant, and the commit requantizes the tail pages in
        place (their scales may grow to admit the new token).
        Returns ``logits [B, V]`` (f32).
        """
        cfg = self.cfg
        quantized = k_scales is not None
        x = self.params.embed[tokens][:, None, :]           # [B,1,d]
        k_news, v_news = [], []
        for l, p in enumerate(self._layers):
            x, (k_new, v_new) = apply_dense_block_paged(
                p, x, cfg, k_pages=k_pages[l], v_pages=v_pages[l],
                block_tables=block_tables, lengths=lengths,
                k_scales=k_scales[l] if quantized else None,
                v_scales=v_scales[l] if quantized else None,
                window=cfg.sliding_window,
            )
            k_news.append(k_new)
            v_news.append(v_new)
        k_news = torch.stack(k_news)                       # [L, B, KH, HD]
        v_news = torch.stack(v_news)
        pages, offs = tail_pages.long(), tail_offsets.long()
        if quantized:
            kv_quant.requantize_insert_run(k_pages, k_scales, pages, offs, k_news)
            kv_quant.requantize_insert_run(v_pages, v_scales, pages, offs, v_news)
        else:
            k_pages[:, pages, offs] = k_news.to(k_pages.dtype)
            v_pages[:, pages, offs] = v_news.to(v_pages.dtype)
        return self._logits(x[:, 0, :])

