"""Backbone assembly (port of ``repro.models.backbones``: the CLIP,
hybrid, dense, MoE, vlm, audio and ssm branches).

The port's "params" are an ``nn.Module`` (``CLIP``, ``HybridLM``,
``DenseLM``, ``MoELM``, ``VisionLM``, ``AudioLM`` or ``XLSTMLM``); the
JAX-layout tree
is its checkpoint form (see ``checkpoint.bridge``).

    init_params(cfg, gen, device)                -> model
    param_shapes(cfg) / params_from_tree(cfg, tree, device)
    encode_pair(model, cfg, batch)               -> (e1, e2)
    forward_hidden(model, cfg, batch)            -> ((B, S, d), aux) [LMs]
    lm_loss(model, cfg, batch)                   -> (loss, metrics)  [LMs]
    encode(model, cfg, batch)                    -> (B, E)           [LMs]
    encode_frames(model, cfg, frames)            -> (B, S_enc, d)   [audio]
    prefill_logits(model, cfg, batch)            -> (B, 1, V)
    init_decode_state(cfg, batch, max_len)       -> decode caches (zeros)
    prepare_decode_state(model, cfg, batch, ...) -> caches, cross filled
    decode_step(model, cfg, state, token, pos)   -> (logits (B, V), state)

The hybrid depth pattern is ``[mamba x every + shared-attn(tied)] x
(L // every) + remainder``: ``supers`` is a ModuleList of super-blocks,
each with a ModuleList ``mambas``, and ``shared_attn`` is one ``Block``
called after every super-block (its weights are tied; each call has its
own KV cache in decode).  The JAX package scans stacked layer axes; here
stacks are walked in Python loops.  Under autograd (grad enabled),
``forward_hidden`` recomputes in the backward, as the JAX package's
``remat=True`` scans do, at one level: each Mamba2 layer and each call
of the shared block keeps only its input and runs its forward again in
the backward (JAX nests a super-block's remat around its layers' own,
which runs a Mamba2 layer's forward three times; here it runs twice);
prefill and decode run without grad and keep nothing.

The dense depth pattern is ``[attn + swiglu] x L``: ``blocks`` is a
ModuleList of ``transformer.Block`` (JAX's ``blocks/...`` stack, qk-norm
and QKV bias as the config says), and decode keeps one KV cache per
layer.  Under autograd its forward recomputes as JAX's
``scan_layers_grouped`` does (``layers.run_layers_grouped`` with
``layers.default_remat_group(n_layers)``, 4 for qwen3-1.7b's 28 layers):
each group of layers keeps only its input and runs again in the
backward; without grad (prefill, decode, eval) nothing is recomputed.
A recompute runs with the weights its layers held at the call
(``torch.func.functional_call`` of them), so that it also runs after the
mesh step's ``functional_call`` of the gathered weights has returned.

The MoE depth pattern is ``[dense? + attn + moe] x (L // every)``:
``supers`` is a ModuleList of super-blocks, each an ``attn_blk`` (a
``transformer.Block`` with ``mlp="none"``), a ``moe`` (``models.moe``)
and, when ``moe.every == 2``, a ``dense_blk`` (a swiglu block run
first); the JAX paths are ``supers/moe/w_gate`` (n_super, E, d, d_ff)
and so on.  Its aux losses (``moe_lb``, ``moe_z``) are averaged over
the super-blocks.  Decode keeps ``moe_kv`` and, with ``every == 2``,
``dense_kv``.  Under autograd the super-blocks recompute as JAX's
``scan_layers_grouped`` does with the carry ``(h, lb, z)``
(``layers.run_layers_grouped`` with ``layers.default_remat_group
(n_super)``): a recompute routes as its forward did, since the forward
is a function of its inputs bit for bit.

The vlm depth pattern is ``[self x (every - 1) + cross] x (L // every)``:
``supers`` is a ModuleList of super-blocks, each a ModuleList ``selfs``
(JAX's ``supers/selfs/...``, two leading axes) and a ``cross_blk`` (a
``transformer.Block(cross=True)``: causal self-attention, then
cross-attention over the image, then the MLP), and ``img_proj`` projects
the stub image embeds (B, n_image_tokens, vision_dim) to d_model.  The
audio encoder-decoder has ``enc_blocks`` (causal, with RoPE, as JAX's
streaming-friendly encoder) and ``enc_norm`` over the stub frames (B,
S // audio_subsample, d_model), and ``dec_blocks`` of cross blocks over
the encoder's output; its ``encode`` is the encoder alone.  Decode keeps
a self cache per block and a cross cache per cross block, which
``prepare_decode_state`` fills once (projected in f32, stored in the
state's dtype, before the GQA repeat; no ``slot_pos``): the vlm's
``self_kv`` (leading axes (n_super, every - 1)), ``cross_self_kv`` and
``cross_kv`` (n_super), the audio's ``self_kv`` and ``cross_kv``
(n_layers).  Under autograd both recompute at one level: the vlm's
image projection runs once, outside any recompute (as JAX's), then each
self block and each cross block on its own (``_vlm_stack``; JAX nests a
super-block's remat around its self blocks' own: the same numbers); the
audio encoder's and decoder's layers each on their own, as JAX's
``remat=True`` scans.  The cross blocks read the image or the encoder's
output through their closure, so its gradient, the sum over the cross
blocks, reaches ``img_proj`` and the encoder.

The ssm (xLSTM) depth pattern is ``cfg.xlstm_pattern[:n_layers]``, split
as JAX's ``_xlstm_groups`` does into its shortest repeating unit and that
unit into contiguous runs of one block kind: ``units`` is a ModuleList
of units, each holding ``g0``, ``g1``, ... (ModuleLists of
``xlstm.MLSTMBlock`` or ``xlstm.SLSTMBlock``), so the JAX paths are
``units/g0/w_up`` with two leading axes (n_units, count).  Under
autograd each mLSTM block is recomputed on its own (JAX nests a unit's
remat around its blocks' own and checkpoints each mLSTM chunk: the same
numbers); an sLSTM block is not, its scan keeping the states its
hand-written backward reads (a recompute would run the token loop a
second time).  Decode keeps ``g0``, ``g1``, ... with the same leading axes:
the mLSTM's (C, n, m) and the sLSTM's (h, c, n, m), all f32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as D
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import clip as C
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import precision as PR
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

CONTRASTIVE_DIM = 512   # joint embedding dim for the contrastive objective
PAIR_DIM = 512          # stub paired-modality embedding dim
FAMILIES = ("clip", "hybrid", "dense", "moe", "vlm", "audio", "ssm")
LM_FAMILIES = ("hybrid", "dense", "moe", "vlm", "audio", "ssm")
CROSS_FAMILIES = ("vlm", "audio")


def _check_family(cfg: ArchConfig, *families) -> None:
    if cfg.family not in (families or FAMILIES):
        raise NotImplementedError(
            f"family {cfg.family!r} has no such path (it is for the "
            f"{', '.join(families or FAMILIES)} families)")


def xlstm_groups(cfg: ArchConfig):
    """JAX's ``_xlstm_groups``: (the unit's contiguous runs [(kind,
    count), ...], n_units), the unit being the shortest repeating unit
    of ``xlstm_pattern[:n_layers]``."""
    pat = cfg.xlstm_pattern[:cfg.n_layers]
    unit = next(pat[:u] for u in range(1, len(pat) + 1)
                if len(pat) % u == 0 and pat[:u] * (len(pat) // u) == pat)
    groups = []
    for ch in unit:
        if groups and groups[-1][0] == ch:
            groups[-1] = (ch, groups[-1][1] + 1)
        else:
            groups.append((ch, 1))
    return groups, len(pat) // len(unit)


class SuperBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, every: int):
        super().__init__()
        self.mambas = nn.ModuleList(SSM.Mamba2(cfg) for _ in range(every))


class _LM(nn.Module):
    """The parameters every LM backbone has (JAX's ``_init_common``):
    ``embed``, ``final_norm``, ``ctr_proj``, ``pair_proj`` and, untied,
    ``lm_head``.  ``ctr_proj``/``pair_proj`` are the contrastive
    objective's projections (``encode``, ``encode_pair``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = L.param(V, d)
        self.final_norm = L.RMSNorm(d)
        self.ctr_proj = L.param(d, CONTRASTIVE_DIM)
        self.pair_proj = L.param(PAIR_DIM, CONTRASTIVE_DIM)
        if not cfg.tie_embeddings:
            self.lm_head = L.param(d, V)

    def reset_parameters(self, gen):
        L.normal_init_(self.embed, gen, 0.02)
        L.dense_init_(self.ctr_proj, gen)
        L.dense_init_(self.pair_proj, gen)
        if hasattr(self, "lm_head"):
            L.dense_init_(self.lm_head, gen)


class HybridLM(_LM):
    """Parameter names follow the JAX params tree: ``_LM``'s, then
    ``supers/mambas/...``, ``shared_attn/...``, ``tail/...`` (when
    ``n_layers`` is not a multiple of ``hybrid_attn_every``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        every = cfg.hybrid_attn_every
        n_super = cfg.n_layers // every
        rem = cfg.n_layers - n_super * every
        self.supers = nn.ModuleList(SuperBlock(cfg, every)
                                    for _ in range(n_super))
        self.shared_attn = T.Block(cfg, T.attn_spec(cfg), mlp="swiglu")
        if rem:
            self.tail = nn.ModuleList(SSM.Mamba2(cfg) for _ in range(rem))


class DenseLM(_LM):
    """``_LM``'s parameters, then ``blocks/...``: the stack of swiglu
    blocks (``blocks/attn/q_norm/scale`` with qk-norm, ``blocks/attn/bq``
    with QKV bias)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.blocks = T.make_stack(cfg, cfg.n_layers, mlp="swiglu")


class MoESuperBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        spec = T.attn_spec(cfg)
        self.attn_blk = T.Block(cfg, spec, mlp="none")
        self.moe = M.MoE(cfg)
        if cfg.moe.every == 2:
            self.dense_blk = T.Block(cfg, spec, mlp="swiglu")


class MoELM(_LM):
    """``_LM``'s parameters, then ``supers/...``: ``supers/attn_blk/...``
    (no ``mlp``; ``n2`` unused, as in JAX), ``supers/moe/...`` and, for
    an MoE layer every other layer, ``supers/dense_blk/...``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        n_super = cfg.n_layers // cfg.moe.every
        self.supers = nn.ModuleList(MoESuperBlock(cfg)
                                    for _ in range(n_super))


class VisionSuperBlock(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        spec = T.attn_spec(cfg)
        self.selfs = nn.ModuleList(
            T.Block(cfg, spec, mlp="swiglu")
            for _ in range(cfg.cross_attn_every - 1))
        self.cross_blk = T.Block(cfg, spec, mlp="swiglu", cross=True)


class VisionLM(_LM):
    """``_LM``'s parameters, then ``supers/selfs/...``,
    ``supers/cross_blk/...`` (with ``n_cross`` and ``cross``) and
    ``img_proj`` (vision_dim, d_model)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        n_super = cfg.n_layers // cfg.cross_attn_every
        self.supers = nn.ModuleList(VisionSuperBlock(cfg)
                                    for _ in range(n_super))
        self.img_proj = L.param(cfg.vision_dim, cfg.d_model)

    def reset_parameters(self, gen):
        super().reset_parameters(gen)
        L.dense_init_(self.img_proj, gen)


class AudioLM(_LM):
    """``_LM``'s parameters, then ``enc_blocks/...`` (swiglu blocks),
    ``enc_norm`` and ``dec_blocks/...`` (cross blocks)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.enc_blocks = T.make_stack(cfg, cfg.enc_layers, mlp="swiglu")
        self.enc_norm = L.RMSNorm(cfg.d_model)
        spec = T.attn_spec(cfg)
        self.dec_blocks = nn.ModuleList(
            T.Block(cfg, spec, mlp="swiglu", cross=True)
            for _ in range(cfg.n_layers))


class XLSTMUnit(nn.Module):
    """One repeating unit: ``g0``, ``g1``, ... in order, each a
    ModuleList of ``count`` blocks of one kind."""

    def __init__(self, cfg: ArchConfig, groups):
        super().__init__()
        for gi, (kind, cnt) in enumerate(groups):
            blk = X.MLSTMBlock if kind == "m" else X.SLSTMBlock
            self.add_module(f"g{gi}", nn.ModuleList(blk(cfg)
                                                    for _ in range(cnt)))


class XLSTMLM(_LM):
    """``_LM``'s parameters, then ``units/g{i}/...`` (two leading axes:
    n_units, the run's count)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        groups, n_units = xlstm_groups(cfg)
        self.units = nn.ModuleList(XLSTMUnit(cfg, groups)
                                   for _ in range(n_units))


_MODELS = {"clip": C.CLIP, "hybrid": HybridLM, "dense": DenseLM,
           "moe": MoELM, "vlm": VisionLM, "audio": AudioLM, "ssm": XLSTMLM}


def _empty(cfg: ArchConfig, device) -> nn.Module:
    with torch.device("meta"):
        model = _MODELS[cfg.family](cfg)
    return model if device == "meta" else model.to_empty(device=device)


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None):
    """Random params from a seeded generator (the draws are made on the
    generator's device), on ``device`` (default: the card; see
    ``repro_torch.device.resolve``).  The JAX package's init recipe, not
    its random numbers."""
    _check_family(cfg)
    device = D.resolve(device)
    if cfg.family == "clip":
        return C.init_clip(cfg, gen).to(device)
    model = _empty(cfg, device)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def meta_model(cfg: ArchConfig) -> nn.Module:
    """The model on the ``meta`` device: no storage, only the structure
    that ``torch.func.functional_call`` runs with weights given to it
    (the sharded train step's gathered params)."""
    _check_family(cfg)
    return _empty(cfg, "meta")


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The JAX-layout params tree as ``meta`` tensors (shapes only, no
    allocation), the ``tree_like`` of a checkpoint restore."""
    _check_family(cfg)
    return bridge.model_to_tree(_empty(cfg, "meta"))


def params_from_tree(cfg: ArchConfig, tree: Dict[str, Any], device=None):
    """A model on ``device`` (default: the card) holding a JAX-layout
    params tree (numpy arrays or tensors), bit for bit."""
    _check_family(cfg)
    model = _empty(cfg, D.resolve(device))
    with torch.no_grad():
        bridge.load_tree(model, tree)
    return model


def encode_pair(model, cfg: ArchConfig, batch, *, impl="flash",
                precision=PR.F32):
    """Two towers.  CLIP: image vs text.  An LM backbone: the stub
    paired-modality embeddings ``pair_embeds`` (B, PAIR_DIM) through
    ``pair_proj`` vs ``encode`` over the tokens."""
    _check_family(cfg)
    if cfg.family == "clip":
        return C.encode_pair(model, batch, impl=impl, precision=precision)
    e2 = encode(model, cfg, batch, impl=impl, precision=precision)
    e1 = (PR.cast_compute(precision, batch["pair_embeds"])
          @ model.pair_proj.to(precision.compute_dtype))
    return PR.cast_output(precision, e1), e2


# ===========================================================================
# The LMs: forward, LM loss, contrastive tower, prefill and
# decode
# ===========================================================================

class _Held(nn.Module):
    """``fn`` over ``modules``: the handle through which a recompute
    swaps in the weights those modules held at the call."""

    def __init__(self, fn, modules):
        super().__init__()
        self.held = nn.ModuleList(modules)
        self.fn = fn

    def forward(self, h):
        return self.fn(h)


def _run(remat: bool, fn, modules, h):
    """``fn(h)``; when ``remat``, recomputed in the backward with the
    weights ``modules`` hold now (the gathered ones of the mesh step's
    ``functional_call``, which has returned by then).  The recompute
    changes no bit."""
    if not remat:
        return fn(h)
    held = _Held(fn, modules)
    weights = dict(held.named_parameters())
    return checkpoint(
        lambda x: torch.func.functional_call(held, weights, (x,)), h,
        use_reentrant=False, preserve_rng_state=False)


def _mamba(m, cfg, impl, chunked):
    return lambda h: SSM.apply_mamba2(m, cfg, h, impl=impl, chunked=chunked)


def forward_hidden(model, cfg: ArchConfig, batch, *,
                   impl="flash", chunked=True, precision=PR.F32):
    """Token path -> (final hidden states (B, S, d) after the final norm,
    aux losses: {} but for the MoE family's ``moe_lb`` / ``moe_z``,
    averaged over its super-blocks).  ``impl`` reaches every attention
    layer (K3 for "flash": each dense layer, the hybrid's shared block,
    each attention block of the MoE LMs) and every Mamba2 layer (K4 for
    "flash"; see ``models.ssm``); the xLSTM has neither and runs no
    kernel.  ``chunked=False`` runs the sequential SSD, and the
    sequential mLSTM.  With grad enabled, each Mamba2 layer, each mLSTM
    block and
    each call of the hybrid's shared block is recomputed once in the
    backward (JAX's ``remat=True`` scans), and the dense and MoE stacks
    under JAX's grouped recompute (``layers.run_layers_grouped``, the
    MoE stack carrying its aux sums), and the vlm's and the audio's
    blocks each on their own (``_vlm_stack``, ``_cross_stack``); a
    recompute changes no number.  The vlm's batch carries
    ``image_embeds`` and the audio's ``frames``; each cross block's
    cross-attention goes through ``impl`` as well (K3 non-causal at (S,
    n_image_tokens) or (S, S_enc) for "flash")."""
    _check_family(cfg, *LM_FAMILIES)
    x = L.embed_tokens(model.embed, batch["tokens"],
                       dtype=precision.compute_dtype)
    remat = torch.is_grad_enabled()
    if cfg.family == "ssm":
        for blk in _xlstm_blocks(model):
            x = _run(remat and isinstance(blk, X.MLSTMBlock),
                     functools.partial(_xlstm_block, blk, cfg,
                                       chunked=chunked), (blk,), x)
        return model.final_norm(x), {}
    if cfg.family in CROSS_FAMILIES:
        if cfg.family == "vlm":
            img = (PR.cast_compute(precision, batch["image_embeds"])
                   @ model.img_proj.to(x.dtype))
            x = _vlm_stack(model, x, img, impl, remat)
        else:
            enc = encode_frames(model, cfg, batch["frames"], impl=impl,
                                precision=precision)
            x = _cross_stack(model.dec_blocks, x, enc, impl, remat)
        return model.final_norm(x), {}
    if cfg.family == "moe":
        def sup_layer(sup, carry):
            h, lb, z = carry
            if hasattr(sup, "dense_blk"):
                h = sup.dense_blk(h, impl=impl)
            h = sup.attn_blk(h, impl=impl)
            h, a = M.apply_moe(sup.moe, cfg, h)
            return h, lb + a["moe_lb"], z + a["moe_z"]
        n_super = len(model.supers)
        carry = (x, 0.0, 0.0)
        if remat:
            carry = L.run_layers_grouped(
                functools.partial(_run, True), model.supers, sup_layer,
                carry, group=L.default_remat_group(n_super))
        else:
            for sup in model.supers:
                carry = sup_layer(sup, carry)
        x, lb, z = carry
        return model.final_norm(x), {"moe_lb": lb / n_super,
                                     "moe_z": z / n_super}
    if cfg.family == "dense":
        def layer(blk, h):
            return blk(h, impl=impl)
        if remat:
            x = L.run_layers_grouped(
                functools.partial(_run, True), model.blocks, layer, x,
                group=L.default_remat_group(cfg.n_layers))
        else:
            for blk in model.blocks:
                x = layer(blk, x)
        return model.final_norm(x), {}

    def shared(h):
        return model.shared_attn(h, impl=impl)
    for sup in model.supers:
        for m in sup.mambas:
            x = _run(remat, _mamba(m, cfg, impl, chunked), (m,), x)
        x = _run(remat, shared, (model.shared_attn,), x)
    for m in getattr(model, "tail", ()):
        x = _run(remat, _mamba(m, cfg, impl, chunked), (m,), x)
    return model.final_norm(x), {}


def _xlstm_blocks(model):
    """The xLSTM's blocks in layer order."""
    for unit in model.units:
        for group in unit.children():
            yield from group


def _xlstm_block(blk, cfg, x, chunked=True):
    if isinstance(blk, X.MLSTMBlock):
        return X.apply_mlstm_block(blk, cfg, x, chunked=chunked)
    return X.apply_slstm_block(blk, cfg, x)


def _cross_stack(blocks, x, kv_x, impl, remat):
    """Cross blocks over ``kv_x``, each recomputed on its own when
    ``remat``; ``kv_x`` comes in through the closure, so its gradient
    adds up over the blocks."""
    for blk in blocks:
        x = _run(remat, lambda h, blk=blk: blk(h, kv_x=kv_x, impl=impl),
                 (blk,), x)
    return x


def _vlm_stack(model, x, img, impl, remat):
    """The vlm's super-blocks over the projected image ``img``; when
    ``remat``, each self block and each cross block recomputed on its
    own."""
    for sup in model.supers:
        for blk in sup.selfs:
            x = _run(remat, functools.partial(blk, impl=impl), (blk,), x)
        x = _cross_stack((sup.cross_blk,), x, img, impl, remat)
    return x


def encode_frames(model, cfg: ArchConfig, frames, *, impl="flash",
                  precision=PR.F32):
    """The audio encoder over stub frame embeddings (B, S_enc, d_model):
    causal self-attention blocks with RoPE (JAX's streaming-friendly
    encoder), each recomputed on its own under autograd (JAX's
    ``remat=True`` scan), then ``enc_norm``."""
    _check_family(cfg, "audio")
    remat = torch.is_grad_enabled()
    h = PR.cast_compute(precision, frames)
    for blk in model.enc_blocks:
        h = _run(remat, functools.partial(blk, impl=impl), (blk,), h)
    return model.enc_norm(h)


def lm_loss(model, cfg: ArchConfig, batch, *, impl="flash",
            precision=PR.F32):
    """(loss, {"ce": loss, **aux}): the vocab-parallel cross entropy of
    the next token, ``batch["labels"]``, over the valid vocab."""
    x, aux = forward_hidden(model, cfg, batch, impl=impl,
                            precision=precision)
    table = model.embed if cfg.tie_embeddings else model.lm_head
    loss = L.vocab_parallel_ce(x, table, batch["labels"],
                               tied=cfg.tie_embeddings,
                               vocab_valid=cfg.vocab_size)
    total = loss + sum(aux.values())
    return total, {"ce": loss, **aux}


def encode(model, cfg: ArchConfig, batch, *, impl="flash",
           precision=PR.F32):
    """Backbone tower -> (B, CONTRASTIVE_DIM) unnormalised embedding: the
    final hidden states averaged over the sequence, through
    ``ctr_proj``; for the audio family the encoder's output alone."""
    if cfg.family == "audio":
        x = encode_frames(model, cfg, batch["frames"], impl=impl,
                          precision=precision)
    else:
        x, _ = forward_hidden(model, cfg, batch, impl=impl,
                              precision=precision)
    pooled = torch.mean(x, dim=1)
    return PR.cast_output(precision, pooled @ model.ctr_proj.to(x.dtype))


def logits_from_hidden(model, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return L.unembed(model.embed, x, transpose=True)
    return L.unembed(model.lm_head, x)


def prefill_logits(model, cfg: ArchConfig, batch, *,
                   impl="flash"):
    """Inference prefill: logits for the last position, (B, 1, V)."""
    x, _ = forward_hidden(model, cfg, batch, impl=impl)
    return logits_from_hidden(model, cfg, x[:, -1:])


def init_decode_state(cfg: ArchConfig, batch_size, max_len,
                      dtype=torch.bfloat16, *, window_override=None,
                      device=None):
    """Zero decode caches.  Dense: ``kv``, one KV cache per layer
    (leading axis n_layers).  MoE: ``moe_kv``, one per attention block
    (leading axis n_super), and ``dense_kv`` for the dense blocks when
    ``moe.every == 2``.  Hybrid: ``mambas`` (conv and SSD state with
    leading axes (n_super, every)), ``shared_kv`` (one KV cache per call
    of the shared block, leading axis n_super) and ``tail``.  vlm:
    ``self_kv`` (leading axes (n_super, every - 1)), ``cross_self_kv``
    (the cross blocks' self-attention, n_super) and ``cross_kv`` (k/v
    of (n_super, B, n_image_tokens, Hkv, hd)).  Audio: ``self_kv``
    (n_layers) and ``cross_kv`` (k/v of (n_layers, B, max_len //
    audio_subsample, Hkv, hd)).  The cross caches hold no ``slot_pos``:
    ``prepare_decode_state`` fills them.  ssm: ``g0``, ``g1``, ... with
    leading axes (n_units, count), the mLSTM's ``C``/``n``/``m`` and the
    sLSTM's ``h``/``c``/``n``/``m``, f32 whatever ``dtype`` and
    ``max_len``."""
    _check_family(cfg, *LM_FAMILIES)
    device = D.resolve(device)
    if cfg.family == "ssm":
        groups, n_units = xlstm_groups(cfg)
        init = {"m": X.init_mlstm_cache, "s": X.init_slstm_cache}
        return {f"g{gi}": init[kind](cfg, batch_size, (n_units, cnt),
                                     device)
                for gi, (kind, cnt) in enumerate(groups)}
    spec = T.attn_spec(cfg, window_override=window_override)

    def cross(lead, n):
        shape = (*lead, batch_size, n, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "vlm":
        every = cfg.cross_attn_every
        n_super = cfg.n_layers // every
        return {"self_kv": A.init_kv_cache(spec, batch_size, max_len, dtype,
                                           device, lead=(n_super, every - 1)),
                "cross_self_kv": A.init_kv_cache(spec, batch_size, max_len,
                                                 dtype, device,
                                                 lead=(n_super,)),
                "cross_kv": cross((n_super,), cfg.n_image_tokens)}
    if cfg.family == "audio":
        return {"self_kv": A.init_kv_cache(spec, batch_size, max_len, dtype,
                                           device, lead=(cfg.n_layers,)),
                "cross_kv": cross((cfg.n_layers,),
                                  max_len // cfg.audio_subsample)}
    if cfg.family == "dense":
        return {"kv": A.init_kv_cache(spec, batch_size, max_len, dtype,
                                      device, lead=(cfg.n_layers,))}
    if cfg.family == "moe":
        n_super = cfg.n_layers // cfg.moe.every
        st = {"moe_kv": A.init_kv_cache(spec, batch_size, max_len, dtype,
                                        device, lead=(n_super,))}
        if cfg.moe.every == 2:
            st["dense_kv"] = A.init_kv_cache(spec, batch_size, max_len,
                                             dtype, device, lead=(n_super,))
        return st
    every = cfg.hybrid_attn_every
    n_super = cfg.n_layers // every
    rem = cfg.n_layers - n_super * every
    st = {"mambas": SSM.init_mamba2_cache(cfg, batch_size, (n_super, every),
                                          device),
          "shared_kv": A.init_kv_cache(spec, batch_size, max_len, dtype,
                                       device, lead=(n_super,))}
    if rem:
        st["tail"] = SSM.init_mamba2_cache(cfg, batch_size, (rem,), device)
    return st


def prepare_decode_state(model, cfg: ArchConfig, batch,
                         batch_size, max_len, dtype=torch.float32, *,
                         window_override=None):
    """Decode state on the model's device, with the cross-attention
    caches filled from the batch's stub inputs, as JAX's: the vlm's from
    ``image_embeds`` through ``img_proj`` in f32, the audio's from the
    encoder over ``frames`` (f32, ``impl="chunked"``: no kernel runs
    here), each cross block's K/V projected once and stored in ``dtype``.
    The hybrid, dense, MoE and ssm families have no cross caches.  Self
    caches start empty; feed the prompt through ``decode_step`` to fill
    them."""
    state = init_decode_state(cfg, batch_size, max_len, dtype,
                              window_override=window_override,
                              device=next(model.parameters()).device)
    if cfg.family not in CROSS_FAMILIES:
        return state
    with torch.no_grad():
        if cfg.family == "vlm":
            kv_x = batch["image_embeds"].float() @ model.img_proj
            blocks = [sup.cross_blk for sup in model.supers]
        else:
            kv_x = encode_frames(model, cfg, batch["frames"],
                                 impl="chunked")
            blocks = list(model.dec_blocks)
        caches = [blk.cross.init_cross_cache(kv_x) for blk in blocks]
    state["cross_kv"] = {k: torch.stack([c[k] for c in caches]).to(dtype)
                         for k in ("k", "v")}
    return state


def decode_step(model, cfg: ArchConfig, state, token, pos: int,
                *, window_override=None):
    """One-token decode.  token: (B, 1) int; ``pos`` the absolute
    position (the ssm family ignores it, as JAX's does).  Updates
    ``state`` in place (JAX returns a new state) and returns ``(logits
    (B, padded_vocab), state)``."""
    _check_family(cfg, *LM_FAMILIES)
    x = L.embed_tokens(model.embed, token)
    pos = int(pos)
    def at(caches, *idx):            # one layer's cache: views, in place
        return {k: v[idx] for k, v in caches.items()}

    if cfg.family == "ssm":
        for u, unit in enumerate(model.units):
            for gi, group in enumerate(unit.children()):
                for i, blk in enumerate(group):
                    dec = (X.decode_mlstm_block
                           if isinstance(blk, X.MLSTMBlock)
                           else X.decode_slstm_block)
                    x, _ = dec(blk, cfg, at(state[f"g{gi}"], u, i), x)
        x = model.final_norm(x)
        return logits_from_hidden(model, cfg, x)[:, 0], state

    if cfg.family == "dense":
        for i, blk in enumerate(model.blocks):
            x, _ = blk.decode(at(state["kv"], i), x, pos, window_override)
        x = model.final_norm(x)
        return logits_from_hidden(model, cfg, x)[:, 0], state

    if cfg.family == "vlm":
        for s, sup in enumerate(model.supers):
            for i, blk in enumerate(sup.selfs):
                x, _ = blk.decode(at(state["self_kv"], s, i), x, pos,
                                  window_override)
            x, _ = sup.cross_blk.decode(at(state["cross_self_kv"], s), x,
                                        pos, window_override,
                                        at(state["cross_kv"], s))
        x = model.final_norm(x)
        return logits_from_hidden(model, cfg, x)[:, 0], state

    if cfg.family == "audio":
        for i, blk in enumerate(model.dec_blocks):
            x, _ = blk.decode(at(state["self_kv"], i), x, pos,
                              window_override, at(state["cross_kv"], i))
        x = model.final_norm(x)
        return logits_from_hidden(model, cfg, x)[:, 0], state

    if cfg.family == "moe":
        for s, sup in enumerate(model.supers):
            if hasattr(sup, "dense_blk"):
                x, _ = sup.dense_blk.decode(at(state["dense_kv"], s), x,
                                            pos, window_override)
            x, _ = sup.attn_blk.decode(at(state["moe_kv"], s), x, pos,
                                       window_override)
            x, _ = M.apply_moe(sup.moe, cfg, x)
        x = model.final_norm(x)
        return logits_from_hidden(model, cfg, x)[:, 0], state

    for s, sup in enumerate(model.supers):
        for i, m in enumerate(sup.mambas):
            x, _ = SSM.decode_mamba2(m, cfg, at(state["mambas"], s, i), x)
        x, _ = model.shared_attn.decode(at(state["shared_kv"], s), x, pos,
                                        window_override)
    for i, m in enumerate(getattr(model, "tail", ())):
        x, _ = SSM.decode_mamba2(m, cfg, at(state["tail"], i), x)
    x = model.final_norm(x)
    return logits_from_hidden(model, cfg, x)[:, 0], state
