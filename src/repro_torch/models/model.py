"""Model assembly of the port: describe / prefill / slot-cache decode /
paged decode for the dense, ``moe`` and ``vlm`` families without
local/global alternation (``vlm``, internvl2, prepends ``image_embeds``
to the prompt at prefill); describe / prefill / decode for gemma2's
local/global alternation (its local layers optionally over a
window-limited ring cache), the ``ssm`` family (mamba2), the ``hybrid``
family (zamba2: groups of Mamba-2 blocks, each followed by one shared
attention block on ``concat(hidden, embedding)``) and the ``encdec``
family (whisper: a bidirectional encoder over ``frames``, and decoder
blocks of self-attention, cross-attention over the encoder's output and
the FFN). :meth:`Model.loss`, the training loss, runs every family.

The counterpart of ``repro/models/model.py``. :class:`Model` is an
``nn.Module`` whose buffers are the parameter tree, leaf name for leaf
name (``blocks.attn.wq`` holds the stacked ``[L, d, H*hd]`` weight).
PyTorch runs eagerly: the reference's ``lax.scan`` over stacked layers is
a Python loop over the layer index, and its functional pool update under
donation is an in-place ``index_put_`` on the pool tensors.

On a mesh of more than one device (every family: ``prefill``,
``sequence``, the paged families' ``decode_paged`` and
``decode``/``decode_into`` with a
:class:`~repro_torch.models.layers.ShardCtx`) the weights are DTensors,
the residual stream is replicated, the logits are sharded by vocabulary,
and the page pool's tensors, the slot caches (gemma2's local ring and
global slots, whisper's decoder slots and cross caches) and the SSM
states are each rank's own block (of the KV heads, of the SSD heads).
:meth:`Model.loss` takes a ``ctx`` too, for every family's training step
on a mesh (FSDP over "data", tensor parallel over "model").
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.local import lookup_rows, vocab_cross_entropy
from repro_torch.kernels import kv_quant
from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    HEADS_ACT,
    KV_HEADS_ACT,
    NULL_CTX,
    _project_qkv,
    _row_parallel,
    _write_slot,
    apply_dense_block,
    apply_dense_block_paged,
    apply_ffn,
    apply_mamba_block,
    apply_shared_block,
    decode_attention,
    describe_attention,
    describe_dense_block,
    describe_mamba_block,
    describe_shared_block,
    dividing_page_tokens,
    rmsnorm,
    slot_operands,
    softcap,
    stack,
)
from repro_torch.models.params import Leaf, flatten_tree, leaves

F32 = torch.float32
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads_act", "head_dim")


#: the families whose KV lives in the serving engine's page pool (without
#: local/global alternation), as the reference's ``Engine`` admits them
PAGED_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in (*PAGED_FAMILIES, "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")


def _check_prefix(cfg: ModelConfig, prefix) -> None:
    """Chunked prefill over a prefix exists for the paged families only:
    the reference's alternating, ssm and hybrid bodies take no prefix."""
    if prefix is not None and (cfg.family not in PAGED_FAMILIES
                               or cfg.local_global_alternating):
        kind = "local/global alternation" if cfg.local_global_alternating else cfg.family
        raise ValueError(f"{cfg.name} ({kind}) has no prefix to attend over")


def check_train_mesh(cfg: ModelConfig, mesh=None) -> None:
    """Every family trains on a mesh of more than one device, moe only
    where no "pod" axis of more than one device shards its experts
    (``mesh``, when given, is the training mesh)."""
    if cfg.family == "moe" and mesh is not None and dict(mesh.shape).get("pod", 1) > 1:
        raise NotImplementedError(
            f"training {cfg.name} on a mesh whose \"pod\" axis has {dict(mesh.shape)['pod']} "
            "devices is not ported: the train rules shard the experts over \"pod\", and "
            "expert parallelism needs a token exchange between its ranks (ROADMAP section 1 "
            "item 5)")


def _stack_layers(cols) -> tuple:
    """Per-layer tuples of cache tensors -> one ``[L, ...]`` stack per
    position in the tuple."""
    return tuple(torch.stack(ts) for ts in zip(*cols))


#: whisper's cache leaves: the decoder's self-attention slots, then the
#: cross caches, which a decode step reads and never writes
ENCDEC_CACHE = ("k", "v", "ck", "cv")
_CROSS = ENCDEC_CACHE[2:]


def _clone_tree(tree: dict) -> dict:
    """A copy of a nested dict of tensors, leaf by leaf."""
    return {k: _clone_tree(t) if isinstance(t, dict) else t.clone()
            for k, t in tree.items()}


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


def _unbind(tree: dict) -> list[dict]:
    """A stacked tree's layer slices (views, no copies), one ``unbind`` a
    leaf. Under autograd each leaf's slices get their gradients stacked
    once; indexing layer by layer would add a zero-padded gradient of the
    whole stack for every layer."""
    parts = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[l] for k, part in parts.items()} for l in range(n)]


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
            self._stacked = params
            self._layers, self._enc_layers = self._slice_layers()
            self._shared = params.get("shared")

    def _slice_layers(self) -> tuple[list, list | None]:
        """Each layer's slice of the stacked leaves: the decoder (or only)
        stack's, and the encoder's for encdec. hybrid: ``[group][j]`` mamba
        blocks; alternation: (local, global) pairs."""
        cfg, blocks = self.cfg, self._stacked["blocks"]
        if cfg.family == "hybrid":
            return [_unbind(group) for group in _unbind(blocks)], None
        if cfg.family == "encdec":
            return _unbind(blocks), _unbind(self._stacked["enc_blocks"])
        return _unbind(blocks), None

    def _layer_slices(self) -> tuple[list, list | None]:
        """The layer slices a forward reads: those cached at construction
        where autograd records nothing (serving), else slices made now. A
        view taken before its leaf was set to require grad carries no
        gradient to it, so a training forward slices the stacked leaves
        itself."""
        if torch.is_grad_enabled():
            return self._slice_layers()
        return self._layers, self._enc_layers

    def _block(self, fn, *args):
        """``fn(*args)``; with ``cfg.remat`` while autograd records, under
        ``torch.utils.checkpoint`` (non-reentrant): the block's activations
        are recomputed in the backward, as the reference's ``_maybe_remat``
        does."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

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
        elif cfg.family == "encdec":
            tree["enc_blocks"] = stack(describe_dense_block(cfg), cfg.encoder_layers)
            dec = describe_dense_block(cfg)
            dec["lnx"] = Leaf((d,), ("embed_act",), init="zeros")
            dec["cross"] = describe_attention(cfg)
            tree["blocks"] = stack(dec, cfg.num_layers)
            tree["enc_ln_f"] = Leaf((d,), ("embed_act",), init="zeros")
        elif cfg.local_global_alternating:
            # gemma2: (local, global) pairs
            pair = {"local": describe_dense_block(cfg), "global": describe_dense_block(cfg)}
            tree["blocks"] = stack(pair, cfg.num_layers // 2)
        else:
            tree["blocks"] = stack(describe_dense_block(cfg), cfg.num_layers)
        return tree

    # --------------------------------------------------------------- cache
    def describe_cache(self, batch: int, max_seq: int) -> dict:
        """The decode cache :meth:`decode` takes. The dense, moe and vlm
        families: dense slot buffers ``{"k", "v"}`` ``[L, batch, max_seq,
        KH, HD]`` bf16 (the serving engine's paged mode keeps its KV in the
        page pool instead); with alternation ``{"local": ..., "global":
        ...}`` of ``L/2`` layers each (a local cache given fewer slots than
        the global one is decoded as a ring). The ssm family: SSD state f32
        and conv state bf16, O(1) in ``max_seq``. The hybrid family: those
        per ``(group, layer)`` plus the shared block's ``shared_k``/
        ``shared_v`` per group. The encdec family: decoder slots ``{"k",
        "v"}`` over ``max_seq`` and the cross caches ``{"ck", "cv"}`` over
        the ``encoder_seq`` encoder positions."""
        cfg = self.cfg
        L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def kv(layers, kh, hd, seq=max_seq, names=("k", "v")):
            return {
                name: Leaf((layers, batch, seq, kh, hd), KV_AXES, torch.bfloat16,
                           init="zeros")
                for name in names
            }

        if cfg.family in PAGED_FAMILIES:
            if cfg.local_global_alternating:
                return {"local": kv(L // 2, KH, HD), "global": kv(L // 2, KH, HD)}
            return kv(L, KH, HD)
        if cfg.family == "ssm":
            return self._ssm_cache((L,), batch)
        if cfg.family == "encdec":
            return {**kv(L, KH, HD), **kv(L, KH, HD, cfg.encoder_seq, _CROSS)}
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

    def _logits(self, h, ctx=NULL_CTX):
        """f32 logits; on a mesh sharded by vocabulary (``[..., V]``), and
        the softcap, elementwise, runs on each rank's shard."""
        p = self.params
        h = rmsnorm(h, ctx.param(p.ln_f))
        logits = softcap((h @ ctx.param(p.head)).to(F32), self.cfg.final_logit_softcap)
        return ctx.constrain(logits, ("batch", *[None] * (logits.dim() - 2), "vocab_act"))

    # ------------------------------------------------------- sequence mode
    def sequence(self, x, positions, prefix=None, prefix_valid=None, frames=None,
                 collect_cache: bool = False, ctx=NULL_CTX):
        """Run the full stack over a token-embedded sequence ``x`` [B,S,d].

        ``prefix``: optional {"k","v"} [L,B,Sp,KH,HD] radix-cached KV for
        chunked prefill (the paged families only). ``prefix_valid`` marks
        how many prefix positions are real when the prefix is padded to a
        bucket. Returns ``(hidden, cache, aux)``: ``aux`` the summed MoE
        load-balance loss (an f32 tensor; the float 0.0 without experts,
        so serving makes no tensor of it), ``cache`` None unless
        ``collect_cache``, else {"k","v"} [L,B,S,KH,HD]; with alternation
        {"local": {"k","v"}, "global": {"k","v"}} of L/2 layers each (local
        layers attend within ``sliding_window``, global ones over
        everything); for the ssm family {"ssm": [L,B,H,P,N] f32, "conv":
        [L,B,W-1,conv_dim]}; for the hybrid family those with a [groups,
        period] lead plus "shared_k"/"shared_v" [groups,B,S,KH,
        hybrid_head_dim], the shared block taking the initial embedding
        ``x`` at every call; for the encdec family {"k","v"} [L,B,S,KH,HD]
        and the cross caches {"ck","cv"} [L,B,S_enc,KH,HD], the decoder
        attending over the encoder's output on ``frames`` [B,S_enc,d].
        With ``cfg.remat`` a recording forward recomputes each block (each
        (local, global) pair, each hybrid group) in the backward. ``ctx``
        places the activations on a mesh (a prefix is then a DTensor
        placed by KV heads, whisper's ``frames`` are placed by rows and
        whole over "model"). On a mesh the ssm and hybrid states are each
        rank's own plain tensors (the SSM state its heads', the conv state
        its heads' ``x`` channels and then all of ``B`` and ``C``,
        :func:`~repro_torch.models.layers.mamba_columns`); the shared
        block's K/V, like every family's K/V and cross caches, are
        DTensors placed by KV heads.
        """
        cfg = self.cfg
        _check_prefix(cfg, prefix)
        layers, enc_layers = self._layer_slices()
        keep = collect_cache   # a block returns its cache only when it is collected
        steps = [(p,) for p in layers]   # each block's arguments after the hidden state
        if cfg.family == "encdec":
            if frames is None:
                raise ValueError(f"{cfg.name} (encdec) takes the encoder's frames")
            enc_out = self._encode(frames, enc_layers, ctx)
            names = ENCDEC_CACHE

            def body(h, p):
                h, kv, ckv = self._decoder_block(ctx.params(p), h, positions, enc_out=enc_out,
                                                 ctx=ctx)
                return h, (*kv, *ckv) if keep else None, 0.0
        elif cfg.family == "ssm":
            names = ("ssm", "conv")

            def body(h, p):
                h, st = apply_mamba_block(ctx.params(p), h, cfg, ctx=ctx)
                return h, st if keep else None, 0.0
        elif cfg.family == "hybrid":
            x0 = x
            names = ("ssm", "conv", "shared_k", "shared_v")

            def body(h, group):
                sts = []
                for p in group:
                    h, st = apply_mamba_block(ctx.params(p), h, cfg, ctx=ctx)
                    sts.append(st)
                # gathered in each group's block, so that remat gathers it
                # again: each group's use reduces its gradient, and autograd
                # adds them in the leaf's type, as on one device
                h, kv = apply_shared_block(ctx.params(self._shared), h, x0, cfg,
                                           positions=positions, ctx=ctx)
                return h, (*_stack_layers(sts), *kv) if keep else None, 0.0
        elif cfg.local_global_alternating:
            names = None

            def body(h, p):
                h, kv_l, a_l = apply_dense_block(ctx.params(p["local"]), h, cfg,
                                                 positions=positions, window=cfg.sliding_window,
                                                 with_aux=True, ctx=ctx)
                h, kv_g, a_g = apply_dense_block(ctx.params(p["global"]), h, cfg,
                                                 positions=positions, window=None,
                                                 with_aux=True, ctx=ctx)
                return h, (*kv_l, *kv_g) if keep else None, a_l + a_g
        else:
            names = ("k", "v")
            if prefix is not None:
                steps = [(p, (prefix["k"][l], prefix["v"][l])) for l, p in enumerate(layers)]

            def body(h, p, pre=None):
                # on a mesh each weight is gathered where FSDP shards it,
                # inside the block so that remat gathers it again
                h, kv, a = apply_dense_block(
                    ctx.params(p), h, cfg, positions=positions, window=cfg.sliding_window,
                    prefix=pre, prefix_valid=prefix_valid, with_aux=True, ctx=ctx)
                return h, kv if keep else None, a

        aux = 0.0   # a tensor once an MoE layer adds to it
        cols = []
        for args in steps:
            x, c, a = self._block(body, x, *args)
            aux = aux + a
            cols.append(c)
        if not collect_cache:
            return x, None, aux
        stacks = _stack_layers(cols)
        if names is None:
            lk, lv, gk, gv = stacks
            return x, {"local": {"k": lk, "v": lv}, "global": {"k": gk, "v": gv}}, aux
        return x, dict(zip(names, stacks)), aux

    def _encode(self, frames, enc_layers=None, ctx=NULL_CTX):
        """The encoder over ``frames`` [B, S_enc, d]: RoPE positions from 0,
        bidirectional attention, ``frames`` cast to bf16 whatever the
        weights' type, as the reference casts them. ``enc_layers``: the
        encoder's layer slices (default: those cached at construction).
        On a mesh ``frames`` are placed by rows over the batch's axes and
        whole over "model", as the reference's ``batch_specs`` places
        them (:meth:`~repro_torch.models.layers.ShardCtx.place`)."""
        cfg = self.cfg
        h = ctx.place(frames, ("batch", None, None)).to(torch.bfloat16)
        pos = torch.arange(h.shape[1], device=h.device)[None, :]
        for p in self._enc_layers if enc_layers is None else enc_layers:
            h, _ = self._block(lambda x, p=p: apply_dense_block(
                ctx.params(p), x, cfg, positions=pos, causal=False, ctx=ctx), h)
        return rmsnorm(h, ctx.param(self.params.enc_ln_f))

    def _decoder_block(self, p, h, positions, *, enc_out=None, cache=None, lengths=None,
                       page_tokens: int = 16, ctx=NULL_CTX):
        """whisper's decoder block: self-attention, cross-attention (no RoPE,
        no bias), the FFN. Sequence mode (``cache`` None): causal
        self-attention and cross-attention over ``enc_out`` through the
        flash kernel; returns ``(h, (k, v), (ck, cv))``. Decode mode
        (``cache = (k, v, ck, cv)``, one layer's slot buffers): the token's
        K/V are written at ``lengths - 1`` in place and attended through
        :func:`decode_attention`; the cross caches are read whole, as pages
        of :func:`dividing_page_tokens` of the encoder length, never
        written. Returns ``(h, (k, v), (ck, cv))`` with the caches.

        On a mesh (``ctx``) the block runs as the dense block does: each
        rank attends its own heads, the cross queries and ``ck``/``cv`` are
        column-parallel products on the rank's heads and KV heads, both
        ``wo`` and the FFN's ``w_down`` reduce their partial sums in f32,
        and in decode mode the slot buffers and the cross caches are the
        rank's own blocks of the KV heads. ``enc_out``'s gradient through
        ``ck``/``cv`` is each model rank's partial sum (its KV heads'
        columns): autograd adds every layer's partials on the rank, and the
        encoder's final norm (its ``on_blocks`` crossing) sums them over
        the ranks once, in f32."""
        cfg = self.cfg
        H, KH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        B, S = h.shape[:2]
        a_in = rmsnorm(h, p["ln1"])
        q, k, v = _project_qkv(p["attn"], a_in, H, KH, HD, positions, cfg.rope_theta, ctx)
        cross = p["cross"]
        if cache is None:
            a = prefill_attention(q, k, v, causal=True)
            h = h + _row_parallel(ctx, a.reshape(B, S, H * HD), p["attn"]["wo"])
            xq = rmsnorm(h, p["lnx"])
            q = ctx.split_heads(xq @ cross["wq"], H, HD, HEADS_ACT)
            ck = ctx.split_heads(enc_out @ cross["wk"], KH, HD, KV_HEADS_ACT)
            cv = ctx.split_heads(enc_out @ cross["wv"], KH, HD, KV_HEADS_ACT)
            a = prefill_attention(q, ck, cv, causal=False)
            kv = (k, v)
        else:
            k_cache, v_cache, ck, cv = cache
            _write_slot(k_cache, ctx.local(k)[:, 0], lengths - 1)
            _write_slot(v_cache, ctx.local(v)[:, 0], lengths - 1)
            a = decode_attention(q[:, 0], *slot_operands(ctx, k_cache, v_cache, KH),
                                 lengths=lengths, page_tokens=page_tokens)
            h = h + _row_parallel(ctx, a[:, None, :], p["attn"]["wo"])
            xq = rmsnorm(h, p["lnx"])
            q = ctx.split_heads(xq @ cross["wq"], H, HD, HEADS_ACT)[:, 0]
            enc_seq = ck.shape[1]
            enc_len = torch.full((B,), enc_seq, dtype=torch.int32, device=h.device)
            a = decode_attention(q, *slot_operands(ctx, ck, cv, KH), lengths=enc_len,
                                 page_tokens=dividing_page_tokens(enc_seq))
            kv = (k_cache, v_cache)
        h = h + _row_parallel(ctx, a.reshape(B, S, H * HD), cross["wo"])
        h = h + apply_ffn(p["ffn"], rmsnorm(h, p["ln2"]), ctx)
        return ctx.constrain(h, ("batch", "seq", "embed_act")), kv, (ck, cv)

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, batch: dict, prefix=None, logit_index=None,
                positions_offset=None, prefix_valid=None, ctx=NULL_CTX):
        """Full- or suffix-context forward; returns ``(logits, cache)``.

        With ``prefix`` (stacked radix-cached KV), this is chunked prefill:
        only ``batch["tokens"]`` (the suffix) is computed, attending over
        prefix+suffix; the returned cache covers the suffix only.
        ``logit_index`` names the token position whose logits to return
        (default: the last). ``positions_offset``/``prefix_valid`` support
        a prefix padded past its real length: the first is the real
        absolute position of the first suffix token (RoPE uses true
        positions), the second masks the padded prefix tail. Each of
        ``logit_index``, ``positions_offset`` and ``prefix_valid`` may be a
        0-dim integer tensor on the device (a captured chunk's operands):
        the positions are then made there, the logit row taken with
        ``index_select`` and the hole's lower end read by the kernel, so no
        value is read on the host; with ints the bits are the same.

        The vlm family prepends ``batch["image_embeds"]`` [B, n_img, d]
        (cast to the embedding's type) to the tokens, as the reference
        does, with a prefix too: positions, the cache and so every later
        ``lengths`` count the image tokens, and ``logit_index`` counts
        from the first text token. The encdec family takes
        ``batch["frames"]`` [B, S_enc, d] for its encoder.

        On a mesh (``ctx``) a ``prefix`` is each rank's own block of the
        KV heads, as the page pool holds it; the cache returned is a
        DTensor placed by KV heads and the logits are sharded by
        vocabulary.
        """
        _check_prefix(self.cfg, prefix)
        with ctx.scope():
            return self._prefill(batch, prefix, logit_index, positions_offset,
                                 prefix_valid, ctx)

    def _prefill(self, batch, prefix, logit_index, positions_offset, prefix_valid, ctx):
        tokens = batch["tokens"]
        # a lookup that a vocabulary-sharded table answers with a masked
        # partial sum, where indexing would gather the whole table
        x = ctx.embedding(tokens, self.params.embed, ("batch", "seq", "embed_act"))
        if prefix is not None and ctx.mesh is not None:
            prefix = {n: ctx.from_local(t, KV_AXES, self._kv_shape(t)) for n, t in prefix.items()}
        n_img = 0
        if self.cfg.family == "vlm":
            img = self._image_embeds(batch, x, ctx)
            n_img = img.shape[1]
            x = torch.cat([img, x], dim=1)
        S = x.shape[1]
        q_off = 0 if prefix is None else prefix["k"].shape[2]
        pos0 = q_off if positions_offset is None else positions_offset
        positions = pos0 + torch.arange(S, device=x.device)[None, :]
        h, cache, _ = self.sequence(x, positions, prefix=prefix, prefix_valid=prefix_valid,
                                    frames=batch.get("frames"), collect_cache=True, ctx=ctx)
        idx = -1 if logit_index is None else n_img + logit_index
        if isinstance(idx, torch.Tensor):
            row = h.index_select(1, idx.reshape(1).long())[:, 0]
        else:
            row = h[:, idx, :]
        return self._logits(row, ctx), cache

    @staticmethod
    def _image_embeds(batch, x, ctx):
        """``batch["image_embeds"]`` [B, n_img, d] in the type of the token
        embeddings ``x``, placed as ``x`` is (rows over the batch's axes,
        whole over "model"), so that they are joined block to block."""
        return ctx.place(batch["image_embeds"], ("batch", "seq", "embed_act")).to(x.dtype)

    def _kv_shape(self, t) -> tuple[int, ...]:
        """The whole shape of a KV stack ``[L, B, S, KH, HD]`` of which
        ``t`` is one rank's block (its heads)."""
        return (*t.shape[:3], self.cfg.num_kv_heads, t.shape[4])

    # -------------------------------------------------------------- train
    def loss(self, batch: dict, ctx=NULL_CTX):
        """The training loss on ``batch["tokens"]`` [B, S+1]: next-token
        cross-entropy of ``tokens[:, :-1]`` predicting ``tokens[:, 1:]``
        (logits and their log-sum-exp in f32), plus 0.01 x the summed MoE
        load-balance loss. vlm prepends ``batch["image_embeds"]`` and scores
        only the text positions; encdec takes ``batch["frames"]``. Returns
        ``(loss, {"ce": ce, "aux": aux})`` as the reference's ``Model.loss``;
        differentiate it with ``torch.autograd``. On the card every
        attention layer runs the flash kernel forward and backward.

        On a mesh (``ctx``; every family, moe only without a "pod" axis of
        more than one device, :func:`check_train_mesh`) the weights are
        DTensors placed by the train rules, ``tokens`` a DTensor sharded by
        rows over the batch's axes ("data"), each rank's rows its own, and
        ``frames`` or ``image_embeds`` (whole on every rank, or DTensors)
        placed so too. The embedding is looked up on each rank's
        vocabulary rows, the residual stream is sharded by rows and whole
        over "model", the logits are sharded by vocabulary and the
        cross-entropy is taken on them
        (:func:`~repro_torch.dist.local.vocab_cross_entropy`): the mean over
        the whole batch, a plain tensor equal on every rank. The MoE layers
        run on each rank's rows and its columns of every expert
        (:func:`~repro_torch.models.layers.apply_moe`), and ``aux`` is the
        mean over the whole batch's groups as well: a plain 0-d tensor
        equal on every rank, as ``ce`` is. The Mamba-2 blocks run on each
        rank's rows and SSD heads
        (:func:`~repro_torch.models.layers.apply_mamba_block`); gemma2's
        (local, global) pairs, whisper's encoder and decoder and internvl2's
        image prefix as the dense block does, each rank attending its own
        heads (:meth:`_decoder_block`)."""
        if ctx.mesh is not None:
            check_train_mesh(self.cfg, ctx.mesh)
        with ctx.scope():
            return self._loss(batch, ctx)

    def _loss(self, batch: dict, ctx):
        cfg = self.cfg
        tokens = batch["tokens"].long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if ctx.mesh is None:
            x = lookup_rows(self.params.embed, inputs)
        else:
            x = ctx.embedding(inputs, self.params.embed, ("batch", "seq", "embed_act"))
        n_img = 0
        if cfg.family == "vlm":
            img = self._image_embeds(batch, x, ctx)
            n_img = img.shape[1]
            x = torch.cat([img, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h, _, aux = self.sequence(x, positions, frames=batch.get("frames"), ctx=ctx)
        aux = torch.as_tensor(aux, dtype=F32, device=h.device)
        if n_img:
            h = h[:, n_img:, :]
        logits = self._logits(h, ctx)
        if ctx.mesh is not None:
            ce = vocab_cross_entropy(logits, labels)
            return ce + 0.01 * aux, {"ce": ce, "aux": aux}
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = (logz - gold).mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, cache, tokens, lengths, *, page_tokens: int = 16, ctx=NULL_CTX):
        """One decode step. ``tokens`` [B]; ``lengths`` [B] = context
        length including the new token. ``cache`` is the tree
        :meth:`describe_cache` describes (slot buffers, the alternating
        families' nested local/global slots, the ssm and hybrid states), or
        the ssm family's {"ssm", "conv"} as :meth:`prefill` returns it; on
        a mesh (``ctx``) each rank's own blocks (:meth:`decode_into`).
        Returns ``(logits [B, V] f32, new_cache)`` and leaves ``cache`` as
        it was (see :meth:`decode_into` for the in-place step)."""
        if self.cfg.family == "encdec":
            # the cross caches are read, never written: shared, not copied
            new_cache = {k: t if k in _CROSS else t.clone() for k, t in cache.items()}
        else:
            new_cache = _clone_tree(cache)
        return (self.decode_into(new_cache, tokens, lengths, page_tokens=page_tokens, ctx=ctx),
                new_cache)

    @torch.no_grad()
    def decode_into(self, state, tokens, lengths=None, *, page_tokens: int = 16,
                    ctx=NULL_CTX):
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
        embedding. encdec: each decoder layer writes its slots as dense
        does and reads the cross caches ``ck``/``cv`` whole, without
        writing them. vlm: as dense (``lengths`` count the image tokens).

        Every path looks the token up through ``ctx.embedding`` and takes
        the logits through ``_logits(..., ctx)``. On a mesh (``ctx``) the
        slot buffers (gemma2's local ring and global slots, whisper's
        decoder slots and cross caches) are this rank's own block of the
        KV heads, the ssm
        and hybrid states its own (the SSM state its heads', the conv state
        its heads' ``x`` channels and all of ``B`` and ``C``, as
        :meth:`prefill` returns them), and the logits are sharded by
        vocabulary."""
        cfg = self.cfg
        with ctx.scope():
            x = self._embed_step(tokens, ctx)
            if cfg.family in ("ssm", "hybrid"):
                return self._decode_ssm(state, x, lengths, page_tokens, ctx)
            positions = (lengths - 1)[:, None]
            if cfg.family == "encdec":
                for l, p in enumerate(self._layers):
                    x, _, _ = self._decoder_block(
                        p, x, positions, lengths=lengths, page_tokens=page_tokens,
                        cache=tuple(state[name][l] for name in ENCDEC_CACHE), ctx=ctx)
                return self._logits(x[:, 0, :], ctx)
            if not cfg.local_global_alternating:
                return self._decode_slots(state, x, positions, lengths, page_tokens, ctx)
            local, glob = state["local"], state["global"]
            slots = local["k"].shape[2]
            ring = slots if slots < glob["k"].shape[2] else None
            for l, p in enumerate(self._layers):
                x, _ = apply_dense_block(
                    p["local"], x, cfg, positions=positions, window=cfg.sliding_window,
                    cache=(local["k"][l], local["v"][l]), lengths=lengths,
                    page_tokens=page_tokens, ring_window=ring, ctx=ctx,
                )
                x, _ = apply_dense_block(
                    p["global"], x, cfg, positions=positions, window=None,
                    cache=(glob["k"][l], glob["v"][l]), lengths=lengths,
                    page_tokens=page_tokens, ctx=ctx,
                )
            return self._logits(x[:, 0, :], ctx)

    def _embed_step(self, tokens, ctx):
        """A decode step's token embeddings ``[B, 1, d]``: on a mesh each
        rank looks up its vocabulary rows (indexing would gather a
        vocabulary-sharded table); with a plain table the same lookup."""
        return ctx.embedding(tokens[:, None], self.params.embed, ("batch", "seq", "embed_act"))

    def _decode_ssm(self, state, x, lengths, page_tokens, ctx):
        """:meth:`decode_into` for the ssm and hybrid families from the
        token's embedding ``x``."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            x0 = x
            positions = (lengths - 1)[:, None]
            for g, group in enumerate(self._layers):
                for j, p in enumerate(group):
                    x = self._mamba_step(p, x, state["ssm"][g, j], state["conv"][g, j], ctx)
                x, _ = apply_shared_block(
                    self._shared, x, x0, cfg, positions=positions,
                    cache=(state["shared_k"][g], state["shared_v"][g]), lengths=lengths,
                    page_tokens=page_tokens, ctx=ctx,
                )
            return self._logits(x[:, 0, :], ctx)
        for l, p in enumerate(self._layers):
            x = self._mamba_step(p, x, state["ssm"][l], state["conv"][l], ctx)
        return self._logits(x[:, 0, :], ctx)

    def _decode_slots(self, state, x, positions, lengths, page_tokens, ctx):
        """:meth:`decode_into` for the paged families without alternation,
        over slot buffers ``{"k", "v"}``."""
        for l, p in enumerate(self._layers):
            x, _ = apply_dense_block(
                p, x, self.cfg, positions=positions, window=self.cfg.sliding_window,
                cache=(state["k"][l], state["v"][l]), lengths=lengths,
                page_tokens=page_tokens, ctx=ctx,
            )
        return self._logits(x[:, 0, :], ctx)

    def _mamba_step(self, p, x, ssm, conv, ctx=NULL_CTX):
        """One mamba layer's decode step, its state updated in place."""
        x, (st, cv) = apply_mamba_block(p, x, self.cfg, cache=(ssm, conv), ctx=ctx)
        ssm.copy_(st)
        conv.copy_(cv)
        return x

    # ------------------------------------------------------- paged decode
    @torch.no_grad()
    def decode_paged(
        self, k_pages, v_pages, tokens, lengths, block_tables,
        tail_pages, tail_offsets, k_scales=None, v_scales=None, ctx=NULL_CTX,
        reduce_amax=None,
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

        On a mesh (``ctx``) the pool's tensors are this rank's own blocks
        of the KV heads: each layer's kernel reads them on the rank's
        heads, and the commit writes the rank's block of the new KV (on an
        int8 pool each tail page's new scale is the whole page's, through
        ``reduce_amax``, the pool's). The logits are sharded by vocabulary.
        """
        cfg = self.cfg
        if cfg.family not in PAGED_FAMILIES or cfg.local_global_alternating:
            raise NotImplementedError(
                f"paged decode serves the {'/'.join(PAGED_FAMILIES)} families without "
                f"local/global alternation, not {cfg.name}")
        with ctx.scope():
            return self._decode_paged(k_pages, v_pages, tokens, lengths, block_tables,
                                      tail_pages, tail_offsets, k_scales, v_scales, ctx,
                                      reduce_amax)

    def _decode_paged(self, k_pages, v_pages, tokens, lengths, block_tables,
                      tail_pages, tail_offsets, k_scales, v_scales, ctx, reduce_amax):
        cfg = self.cfg
        quantized = k_scales is not None
        x = self._embed_step(tokens, ctx)                  # [B,1,d]
        k_news, v_news = [], []
        for l, p in enumerate(self._layers):
            x, (k_new, v_new) = apply_dense_block_paged(
                p, x, cfg, k_pages=k_pages[l], v_pages=v_pages[l],
                block_tables=block_tables, lengths=lengths,
                k_scales=k_scales[l] if quantized else None,
                v_scales=v_scales[l] if quantized else None,
                window=cfg.sliding_window, ctx=ctx,
            )
            k_news.append(ctx.local(k_new))
            v_news.append(ctx.local(v_new))
        k_news = torch.stack(k_news)                       # [L, B, KH, HD]
        v_news = torch.stack(v_news)
        pages, offs = tail_pages.long(), tail_offsets.long()
        if quantized:
            kv_quant.requantize_insert_run(k_pages, k_scales, pages, offs, k_news, reduce_amax)
            kv_quant.requantize_insert_run(v_pages, v_scales, pages, offs, v_news, reduce_amax)
        else:
            k_pages[:, pages, offs] = k_news.to(k_pages.dtype)
            v_pages[:, pages, offs] = v_news.to(v_pages.dtype)
        return self._logits(x[:, 0, :], ctx)

