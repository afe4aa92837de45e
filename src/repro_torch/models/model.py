"""Model assembly of the port: describe / prefill / slot-cache decode /
paged decode for the dense and ``moe`` families without local/global
alternation; describe / prefill / decode for gemma2's local/global
alternation (its local layers optionally over a window-limited ring
cache), the ``ssm`` family (mamba2) and the ``hybrid`` family (zamba2:
groups of Mamba-2 blocks, each followed by one shared attention block on
``concat(hidden, embedding)``).

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
    apply_mamba_block,
    apply_shared_block,
    describe_dense_block,
    describe_mamba_block,
    describe_shared_block,
    rmsnorm,
    softcap,
    stack,
)
from repro_torch.models.params import Leaf, flatten_tree, leaves

F32 = torch.float32
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads_act", "head_dim")


#: the families the port does not serve yet, each with its ROADMAP §1 item
_NOT_PORTED = {
    "encdec": "whisper's encoder-decoder is ROADMAP §1 item 11",
    "vlm": "internvl2's image prefix is ROADMAP §1 item 11",
}

#: the families whose KV lives in the serving engine's page pool (without
#: local/global alternation)
PAGED_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name} is {cfg.family}: {_NOT_PORTED[cfg.family]}")
    if cfg.family not in (*PAGED_FAMILIES, "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family}")


def _check_prefix(cfg: ModelConfig, prefix) -> None:
    """Chunked prefill over a prefix exists for the paged families only:
    the reference's alternating, ssm and hybrid bodies take no prefix."""
    if prefix is not None and (cfg.family not in PAGED_FAMILIES
                               or cfg.local_global_alternating):
        kind = "local/global alternation" if cfg.local_global_alternating else cfg.family
        raise ValueError(f"{cfg.name} ({kind}) has no prefix to attend over")


def _kv_tree(ks, vs) -> dict:
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _clone_tree(tree: dict) -> dict:
    """A copy of a nested dict of tensors, leaf by leaf."""
    return {k: _clone_tree(t) if isinstance(t, dict) else t.clone() for k, t in tree.items()}


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
            blocks = params["blocks"]
            if cfg.family == "hybrid":
                # [groups, period] mamba blocks, then the one shared block
                period = cfg.shared_attn_period
                self._layers = [
                    [_layer_view(_layer_view(blocks, g), j) for j in range(period)]
                    for g in range(cfg.num_layers // period)
                ]
                self._shared = params["shared"]
            else:
                # alternation stacks (local, global) pairs
                n = cfg.num_layers // 2 if cfg.local_global_alternating else cfg.num_layers
                self._layers = [_layer_view(blocks, l) for l in range(n)]

    # ------------------------------------------------------------ describe
    def describe(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        tree = {
            "embed": Leaf((v, d), ("vocab", "embed"), scale=0.02),
            "ln_f": Leaf((d,), ("embed_act",), init="zeros"),
            "head": Leaf((d, v), ("embed", "vocab")),
        }
        if cfg.family == "ssm":
            tree["blocks"] = stack(describe_mamba_block(cfg), cfg.num_layers)
        elif cfg.family == "hybrid":
            period = cfg.shared_attn_period
            tree["blocks"] = stack(stack(describe_mamba_block(cfg), period),
                                   cfg.num_layers // period)
            tree["shared"] = describe_shared_block(cfg)
        elif cfg.local_global_alternating:
            # gemma2: (local, global) pairs
            pair = {"local": describe_dense_block(cfg), "global": describe_dense_block(cfg)}
            tree["blocks"] = stack(pair, cfg.num_layers // 2)
        else:
            tree["blocks"] = stack(describe_dense_block(cfg), cfg.num_layers)
        return tree

    # --------------------------------------------------------------- cache
    def describe_cache(self, batch: int, max_seq: int) -> dict:
        """The decode cache :meth:`decode` takes. The dense and moe
        families: dense slot buffers ``{"k", "v"}`` ``[L, batch, max_seq,
        KH, HD]`` bf16 (the serving engine's paged mode keeps its KV in the
        page pool instead); with alternation ``{"local": ..., "global":
        ...}`` of ``L/2`` layers each (a local cache given fewer slots than
        the global one is decoded as a ring). The ssm family: SSD state f32
        and conv state bf16, O(1) in ``max_seq``. The hybrid family: those
        per ``(group, layer)`` plus the shared block's ``shared_k``/
        ``shared_v`` per group."""
        cfg = self.cfg
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def kv(layers, kh, hd):
            return {
                name: Leaf((layers, batch, max_seq, kh, hd), KV_AXES, torch.bfloat16,
                           init="zeros")
                for name in ("k", "v")
            }

        if cfg.family in PAGED_FAMILIES:
            if cfg.local_global_alternating:
                return {"local": kv(L // 2, KH, HD), "global": kv(L // 2, KH, HD)}
            return kv(L, KH, HD)
        if cfg.family == "ssm":
            return self._ssm_cache((L,), batch)
        groups = L // cfg.shared_attn_period
        c = self._ssm_cache((groups, cfg.shared_attn_period), batch)
        c.update({f"shared_{k}": t for k, t in kv(groups, KH, cfg.hybrid_head_dim).items()})
        return c

    def _ssm_cache(self, lead: tuple[int, ...], batch: int) -> dict:
        cfg = self.cfg
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
        lead_axes = tuple("layers" for _ in lead)
        return {
            "ssm": Leaf((*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        (*lead_axes, "batch", "ssm_heads_act", None, None), F32, init="zeros"),
            "conv": Leaf((*lead, batch, cfg.ssm_conv_width - 1, conv_dim),
                         (*lead_axes, "batch", None, "ssm_heads_act"), init="zeros"),
        }

    def _logits(self, h):
        p = self.params
        h = rmsnorm(h, p.ln_f)
        return softcap((h @ p.head).to(F32), self.cfg.final_logit_softcap)

    # ------------------------------------------------------- sequence mode
    def sequence(self, x, positions, prefix=None, prefix_valid=None):
        """Run the full stack over a token-embedded sequence ``x`` [B,S,d].

        ``prefix``: optional {"k","v"} [L,B,Sp,KH,HD] radix-cached KV for
        chunked prefill (the paged families only). ``prefix_valid`` marks
        how many prefix positions are real when the prefix is padded to a
        bucket. Returns ``(hidden, cache)`` with cache {"k","v"}
        [L,B,S,KH,HD]; with alternation {"local": {"k","v"}, "global":
        {"k","v"}} of L/2 layers each (local layers attend within
        ``sliding_window``, global ones over everything); for the ssm
        family {"ssm": [L,B,H,P,N] f32, "conv": [L,B,W-1,conv_dim]}; for
        the hybrid family those with a [groups, period] lead plus
        "shared_k"/"shared_v" [groups,B,S,KH,hybrid_head_dim], the shared
        block taking the initial embedding ``x`` at every call.
        """
        cfg = self.cfg
        _check_prefix(cfg, prefix)
        if cfg.family == "ssm":
            sts, cvs = [], []
            for p in self._layers:
                x, (st, cv) = apply_mamba_block(p, x, cfg)
                sts.append(st)
                cvs.append(cv)
            return x, {"ssm": torch.stack(sts), "conv": torch.stack(cvs)}
        if cfg.family == "hybrid":
            x0 = x
            sts, cvs, ks, vs = [], [], [], []
            for group in self._layers:
                g_sts, g_cvs = [], []
                for p in group:
                    x, (st, cv) = apply_mamba_block(p, x, cfg)
                    g_sts.append(st)
                    g_cvs.append(cv)
                x, (k, v) = apply_shared_block(self._shared, x, x0, cfg, positions=positions)
                sts.append(torch.stack(g_sts))
                cvs.append(torch.stack(g_cvs))
                ks.append(k)
                vs.append(v)
            return x, {"ssm": torch.stack(sts), "conv": torch.stack(cvs),
                       "shared_k": torch.stack(ks), "shared_v": torch.stack(vs)}
        if cfg.local_global_alternating:
            kvs = {"local": ([], []), "global": ([], [])}
            for p in self._layers:
                for kind, window in (("local", cfg.sliding_window), ("global", None)):
                    x, (k, v) = apply_dense_block(p[kind], x, cfg, positions=positions,
                                                  window=window)
                    kvs[kind][0].append(k)
                    kvs[kind][1].append(v)
            return x, {kind: _kv_tree(*pair) for kind, pair in kvs.items()}
        ks, vs = [], []
        for l, p in enumerate(self._layers):
            pre = (prefix["k"][l], prefix["v"][l]) if prefix is not None else None
            x, (k, v) = apply_dense_block(
                p, x, cfg, positions=positions, window=cfg.sliding_window,
                prefix=pre, prefix_valid=prefix_valid,
            )
            ks.append(k)
            vs.append(v)
        return x, _kv_tree(ks, vs)

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
        _check_prefix(self.cfg, prefix)
        tokens = batch["tokens"]
        x = self.params.embed[tokens]
        S = x.shape[1]
        q_off = 0 if prefix is None else prefix["k"].shape[2]
        pos0 = q_off if positions_offset is None else positions_offset
        positions = pos0 + torch.arange(S, device=x.device)[None, :]
        h, cache = self.sequence(x, positions, prefix=prefix, prefix_valid=prefix_valid)
        idx = -1 if logit_index is None else logit_index
        return self._logits(h[:, idx, :]), cache

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, cache, tokens, lengths, *, page_tokens: int = 16):
        """One decode step. ``tokens`` [B]; ``lengths`` [B] = context
        length including the new token. ``cache`` is the tree
        :meth:`describe_cache` describes (slot buffers, the alternating
        families' nested local/global slots, the ssm and hybrid states), or
        the ssm family's {"ssm", "conv"} as :meth:`prefill` returns it.
        Returns ``(logits [B, V] f32, new_cache)`` and leaves ``cache`` as
        it was (see :meth:`decode_into` for the in-place step)."""
        new_cache = _clone_tree(cache)
        return self.decode_into(new_cache, tokens, lengths, page_tokens=page_tokens), new_cache

    @torch.no_grad()
    def decode_into(self, state, tokens, lengths=None, *, page_tokens: int = 16):
        """:meth:`decode` updating ``state`` in place, where the reference
        returned new arrays: a captured decode graph reads and writes one
        static cache at fixed addresses. Returns ``logits [B, V]`` (f32).

        Dense and moe: each layer writes the new token's KV into its slot
        buffers at ``lengths - 1``, then attends over them through
        :func:`~repro_torch.models.layers.decode_attention`, which on the
        card reads the slots as ``page_tokens``-token pages with the
        paged-attention kernel. Alternation: each (local, global) pair in
        turn; the local layers run as a ring (``ring_window`` = their slot
        count) when the local cache has fewer slots than the global one,
        else over the window. ssm: ``lengths`` is unused (the recurrence
        needs none); each layer's new state is computed whole before it is
        copied over the old. hybrid: each group's mamba layers as ssm, then
        the shared block over the group's slot buffers, fed the token's
        embedding."""
        cfg = self.cfg
        x = self.params.embed[tokens][:, None, :]           # [B,1,d]
        if cfg.local_global_alternating:
            positions = (lengths - 1)[:, None]
            local, glob = state["local"], state["global"]
            slots = local["k"].shape[2]
            ring = slots if slots < glob["k"].shape[2] else None
            for l, p in enumerate(self._layers):
                x, _ = apply_dense_block(
                    p["local"], x, cfg, positions=positions, window=cfg.sliding_window,
                    cache=(local["k"][l], local["v"][l]), lengths=lengths,
                    page_tokens=page_tokens, ring_window=ring,
                )
                x, _ = apply_dense_block(
                    p["global"], x, cfg, positions=positions, window=None,
                    cache=(glob["k"][l], glob["v"][l]), lengths=lengths,
                    page_tokens=page_tokens,
                )
            return self._logits(x[:, 0, :])
        if cfg.family in PAGED_FAMILIES:
            positions = (lengths - 1)[:, None]
            for l, p in enumerate(self._layers):
                x, _ = apply_dense_block(
                    p, x, cfg, positions=positions, window=cfg.sliding_window,
                    cache=(state["k"][l], state["v"][l]), lengths=lengths,
                    page_tokens=page_tokens,
                )
            return self._logits(x[:, 0, :])
        if cfg.family == "hybrid":
            x0 = x
            positions = (lengths - 1)[:, None]
            for g, group in enumerate(self._layers):
                for j, p in enumerate(group):
                    x = self._mamba_step(p, x, state["ssm"][g, j], state["conv"][g, j])
                x, _ = apply_shared_block(
                    self._shared, x, x0, cfg, positions=positions,
                    cache=(state["shared_k"][g], state["shared_v"][g]), lengths=lengths,
                    page_tokens=page_tokens,
                )
            return self._logits(x[:, 0, :])
        for l, p in enumerate(self._layers):
            x = self._mamba_step(p, x, state["ssm"][l], state["conv"][l])
        return self._logits(x[:, 0, :])

    def _mamba_step(self, p, x, ssm, conv):
        """One mamba layer's decode step, its state updated in place."""
        x, (st, cv) = apply_mamba_block(p, x, self.cfg, cache=(ssm, conv))
        ssm.copy_(st)
        conv.copy_(cv)
        return x

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
        if cfg.family not in PAGED_FAMILIES or cfg.local_global_alternating:
            raise NotImplementedError(
                f"paged decode serves the {'/'.join(PAGED_FAMILIES)} families without "
                f"local/global alternation, not {cfg.name}")
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

