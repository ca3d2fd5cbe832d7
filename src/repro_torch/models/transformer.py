"""Port of ``repro/models/transformer.py``: parameter init
(``init_params`` :114 with ``_init_attn_slot`` :50, ``_init_mlp_slot``
:66 and ``_init_group`` :83, every block kind and MoE MLPs),
``_attn_apply`` (:137; its sharded-decode and DP-reshard branches wait
for items 4 and 3.3), ``_mlp_apply`` (:208, dense gated, GELU and MoE),
``_embed_inputs`` (:252), ``_rope_tables`` (:258, M-RoPE included),
``_unembed`` (:270), and serving: ``init_cache`` (:351, every slot kind),
``_apply_group_serve`` (:372), ``prefill`` (:406) and ``decode_step``
(:429); and training: ``MOE_AUX_COEF`` (:39), ``_apply_group_train``
(:227) for 'a' layers with dense MLPs, ``_forward`` (:276) and
``loss_fn`` (:315).

Parameters are a plain dict with one entry per layer in ``"layers"``; the
reference's ``scan`` over stacked groups is a Python loop here. Layer i is
slot i mod ``pattern_period`` of a group: its kind is
``cfg.layer_kind(i)``, and its MLP is MoE where ``cfg.layer_is_moe``
says so of that slot, as the reference asks it of the slot. A layer holds
``norm1`` and its mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``);
'a' and 'm' layers also ``norm2`` and an ``mlp`` (dense, or MoE with a
``router``). Weights keep the reference's (in, out) layout (``x @ w``),
so that carrying them across (:func:`repro_torch.convert.
lm_params_from_jax`) is a copy. The cache is ``{"pos": int, "layers":
[...]}``: (B, Hkv, S_max, hd) ``k``/``v`` buffers for an attention layer,
the Mamba (``conv``, ``ssm``), mLSTM (``C``, ``n``, ``conv``) or sLSTM
(``c``, ``n``, ``h``, ``m``) state for the others; ``prefill`` fills a new
cache and ``decode_step`` writes the new key and value into the buffers
and the new states into the layers' dicts in place and advances ``pos``
on the same dict (the reference returned a new cache). A mixer input of
length 1 takes the mixer's decode step from the cache, in a prefill too,
as in the reference; serving drops the MoE aux loss.

Training runs the same layers on one device. ``cfg.remat == "layer"``
wraps each layer in ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, the reference's ``jax.checkpoint`` of a layer
group; ``scan_layers`` changes nothing, since the port loops over its
layers either way. The cross entropy runs in the reference's checkpointed
sequence chunks, so the (B, S, V) float32 logits never exist at once. On
the card the attention of a long sequence is the flash-attention kernel,
whose gradient is the hand-written backward kernel
(:class:`repro_torch.kernels.flash_attention.FlashAttentionFn`).

Under a training mesh (an active
:class:`~repro_torch.distributed.meshctx.MeshContext`, whose ``specs``
give the parameters' layout), each rank computes on its local shards,
with the reference's GSPMD semantics made explicit in named collectives
(:mod:`repro_torch.distributed.collectives`): FSDP leaves are all-gathered
where a layer uses them; attention (when the q heads tile the model axis),
the MLP, the embedding and the cross entropy are split over the model
axis, with the attention kernels running on each rank's local heads. The
loss is the mean over this rank's rows; the trainer reduces the gradients
over the data axes.

Training a config with layers of kind 'm', 'M' or 's' (Mamba, mLSTM,
sLSTM) or with MoE MLPs is not ported: :func:`loss_fn` (and the
``Trainer``) raise ``NotImplementedError`` for it (:func:`check_trainable`,
ROADMAP §1, item 3.2b).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import collectives as C
from ..distributed.meshctx import MeshContext, get_mesh_context
from .config import ModelConfig
from .layers import (apply_rope, gen_device, gqa_attention, init_dense,
                     init_norm, mrope_cos_sin, rms_norm, rope_cos_sin,
                     swiglu_mlp)
from .moe import init_moe_params, moe_ffn
from .ssm import (init_mamba_params, init_mamba_state, mamba_decode_step,
                  mamba_forward)
from .xlstm import (init_mlstm_params, init_mlstm_state, init_slstm_params,
                    init_slstm_state, mlstm_decode_step, mlstm_forward,
                    slstm_decode_step, slstm_forward)

__all__ = ["init_params", "loss_fn", "prefill", "decode_step", "init_cache",
           "model_dtype", "check_trainable"]

MOE_AUX_COEF = 0.01


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is
    attention with a dense MLP: the port builds, converts and serves every
    config, and trains those."""
    other = sorted(set(cfg.block_pattern) - {"a"})
    if other or cfg.num_experts:
        what = ", ".join([f"{k!r} layers" for k in other]
                         + (["MoE MLPs"] if cfg.num_experts else []))
        raise NotImplementedError(
            f"{cfg.name}: training a model with {what} is not ported yet "
            f"(ROADMAP §1, item 3.2b: training of the MoE, Mamba and xLSTM "
            f"mixers)")


#: the mixers other than attention: the layer's key, its forward (a
#: prefill asks it for the decode state) and its decode step
_MIXERS = {
    "m": ("mamba", mamba_forward, mamba_decode_step),
    "M": ("mlstm", mlstm_forward, mlstm_decode_step),
    "s": ("slstm", slstm_forward, slstm_decode_step),
}
_INIT_MIXER = {"m": init_mamba_params, "M": init_mlstm_params,
               "s": init_slstm_params}


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_attn_slot(gen, cfg: ModelConfig, dtype) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = dict(wq=init_dense(gen, (d, hq * hd), dtype=dtype),
             wk=init_dense(gen, (d, hkv * hd), dtype=dtype),
             wv=init_dense(gen, (d, hkv * hd), dtype=dtype),
             wo=init_dense(gen, (hq * hd, d), dtype=dtype))
    if cfg.qk_norm:
        p["q_norm"] = init_norm((hd,), dtype, gen_device(gen))
        p["k_norm"] = init_norm((hd,), dtype, gen_device(gen))
    return p


def _init_mlp_slot(gen, cfg: ModelConfig, slot: int, dtype
                   ) -> Optional[Dict[str, Any]]:
    """Slot ``slot``'s MLP: MoE where ``cfg.layer_is_moe(slot)``, else
    dense, or ``None`` without a hidden width."""
    if cfg.layer_is_moe(slot):
        return init_moe_params(gen, cfg, dtype)
    d, f = cfg.d_model, cfg.d_ff
    if not f:
        return None
    if not cfg.mlp_gated:
        return dict(wi=init_dense(gen, (d, f), dtype=dtype),
                    wd=init_dense(gen, (f, d), dtype=dtype))
    return dict(wg=init_dense(gen, (d, f), dtype=dtype),
                wu=init_dense(gen, (d, f), dtype=dtype),
                wd=init_dense(gen, (f, d), dtype=dtype))


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator]
                ) -> Dict[str, Any]:
    """Random weights with the reference's distributions, drawn in order
    from ``gen`` and placed on its device: the embedding N(0, 0.02²), every
    projection N(0, 1/fan_in), norms 1, and each mixer's leaves as its
    module draws them. ``gen=None`` gives the same tree of
    ``device="meta"`` tensors (shapes and dtypes, nothing allocated)."""
    dtype, dev = model_dtype(cfg), gen_device(gen)
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens" or cfg.tie_embeddings:
        params["embed"] = init_dense(gen, (cfg.vocab_size, cfg.d_model),
                                     scale=0.02, dtype=dtype)
    layers = []
    for i in range(cfg.num_layers):
        j, kind = i % cfg.pattern_period, cfg.layer_kind(i)
        layer: Dict[str, Any] = dict(
            norm1=init_norm((cfg.d_model,), dtype, dev))
        if kind == "a":
            layer["attn"] = _init_attn_slot(gen, cfg, dtype)
        else:
            layer[_MIXERS[kind][0]] = _INIT_MIXER[kind](gen, cfg, dtype)
        mlp = _init_mlp_slot(gen, cfg, j, dtype) if kind in ("a", "m") \
            else None
        if mlp is not None:
            layer["norm2"] = init_norm((cfg.d_model,), dtype, dev)
            layer["mlp"] = mlp
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = init_norm((cfg.d_model,), dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _attn_apply(layer, x, cos, sin, cfg: ModelConfig, *, causal=True,
                cache=None, pos: Optional[int] = None, par=None):
    """x: (B, S, D). With ``cache``, write k/v at ``pos`` into its buffers
    (in place) and attend: a prefill over the fresh k/v, causally, and a
    decode step (S = 1) over the whole masked buffer. Returns (out,
    cache).

    Under a mesh whose layout splits the q heads over the model axis
    (``par.attn``): ``wq``, ``wk`` and ``wv`` are column-parallel, each rank
    attending with its own q heads and the kv heads they read, and ``wo``
    row-parallel, its partial products summed over the model group. Where
    the kv heads do not tile the model axis, ``wk`` and ``wv`` are whole on
    every model rank and each takes the kv heads it needs. A replicated
    leaf that only this rank's heads use (``q_norm``, ``k_norm``, a whole
    ``wk`` / ``wv``) passes :func:`~repro_torch.distributed.collectives.
    copy_to`, so its gradient is summed over the model group."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    a = layer["attn"]
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    wk, wv = a["wk"], a["wv"]
    qn, kn = a.get("q_norm"), a.get("k_norm")
    tp = par is not None and par.attn
    if tp:
        h = C.copy_to(h, par.group)
        hq //= par.n
        if par.kv_split:
            hkv //= par.n
        else:
            wk, wv = C.copy_to(wk, par.group), C.copy_to(wv, par.group)
        if cfg.qk_norm:
            qn, kn = C.copy_to(qn, par.group), C.copy_to(kn, par.group)
    q = (h @ a["wq"]).view(b, s, hq, hd)
    k = (h @ wk).view(b, s, hkv, hd)
    v = (h @ wv).view(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    q = apply_rope(q.transpose(1, 2), cos, sin)  # (B, H, S, hd)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    if tp and not par.kv_split:
        k, v = _local_kv(k, v, par.r, hq, cfg.num_heads // cfg.num_kv_heads)
    chunks = dict(q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    if cache is not None:
        if pos + s > cache["k"].shape[2]:
            raise ValueError(f"the cache holds {cache['k'].shape[2]} "
                             f"positions; cannot write {s} at {pos}")
        cache["k"][:, :, pos:pos + s] = k
        cache["v"][:, :, pos:pos + s] = v
        if s == 1:
            # decode: read the whole (masked) buffer — the HBM-bound path
            att = gqa_attention(q, cache["k"], cache["v"], causal=False,
                                kv_valid_len=pos + s, impl="plain", **chunks)
        else:
            # prefill: attend causally over the fresh k/v, not the buffer
            att = gqa_attention(q, k, v, causal=True, **chunks)
    else:
        att = gqa_attention(q, k, v, causal=causal, **chunks)
    out = att.transpose(1, 2).reshape(b, s, hq * hd) @ a["wo"]
    if tp:
        out = C.reduce_from(out, par.group)
    return x + out, cache


def _local_kv(k, v, r: int, hq_l: int, rep: int):
    """The kv heads (B, Hkv, S, D) that model rank ``r``'s ``hq_l`` q heads
    read (q head i reads kv head i // rep): a run of heads when each serves
    whole groups of the local q heads, else one head per q head."""
    idx = [(r * hq_l + j) // rep for j in range(hq_l)]
    if hq_l % rep == 0 or rep % hq_l == 0:
        return k[:, idx[0]:idx[-1] + 1], v[:, idx[0]:idx[-1] + 1]
    ix = torch.tensor(idx, device=k.device)
    return k.index_select(1, ix), v.index_select(1, ix)


def _mlp_apply(layer, x, cfg: ModelConfig, par=None):
    """Post-mixer MLP: dense (gated SwiGLU or tanh-approximate GELU), or
    MoE (:func:`~repro_torch.models.moe.moe_ffn`, its aux loss dropped:
    only serving reaches it). Under a mesh whose layout splits the hidden
    width (``par.mlp``): ``wg``, ``wu``, ``wi`` column-parallel, ``wd``
    row-parallel with its partial products summed over the model group."""
    if "mlp" not in layer:
        return x
    h = rms_norm(x, layer["norm2"], cfg.norm_eps)
    mlp = layer["mlp"]
    if "router" in mlp:
        return x + moe_ffn(mlp, h, cfg)[0]
    tp = par is not None and par.mlp
    if tp:
        h = C.copy_to(h, par.group)
    if cfg.mlp_gated:
        y = swiglu_mlp(h, mlp["wg"], mlp["wu"], mlp["wd"])
    else:
        u = F.gelu((h @ mlp["wi"]).float(), approximate="tanh").to(h.dtype)
        y = u @ mlp["wd"]
    if tp:
        y = C.reduce_from(y, par.group)
    return x + y


def _apply_group_train(layer, x, cos, sin, cfg: ModelConfig, par=None,
                       lspec=None):
    """One layer of the training forward (the reference's group of one 'a'
    slot): attention, then the MLP. The reference also returns the group's
    MoE aux loss, which is 0 without experts. Under a mesh the layer's
    FSDP-sharded leaves are gathered first, here, so that a checkpointed
    layer gathers them again when it is recomputed."""
    if par is not None:
        layer = par.use_tree(layer, lspec)
    x, _ = _attn_apply(layer, x, cos, sin, cfg, par=par)
    return _mlp_apply(layer, x, cfg, par=par)


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------

class _Par:
    """The model's view of an active training mesh: the parameters'
    layout (the context's ``specs``), the model group, its width ``n`` and
    this rank's index ``r`` on it, and which products the layout splits
    over it. A product is split where its weight's spec puts the model
    axis (a bare name) on a dimension; every other sharded dimension (FSDP:
    a tuple of axes) is all-gathered where the leaf is used."""

    def __init__(self, ctx: MeshContext, cfg: ModelConfig):
        self.ctx, self.specs = ctx, ctx.specs
        ma = ctx.model_axis
        has_model = ma in tuple(ctx.mesh.mesh_dim_names)
        self.group = ctx.group(ma) if has_model else None
        self.n = ctx.size(ma) if has_model else 1
        self.r = ctx.index(ma) if has_model else 0

        def split(spec, dim):
            return has_model and spec is not None and spec[dim] == ma

        sp = self.specs or {}
        l0 = sp.get("layers", [{}])[0] if sp else {}
        self.attn = split(l0.get("attn", {}).get("wq"), 1)
        self.kv_split = split(l0.get("attn", {}).get("wk"), 1)
        self.mlp = split(l0.get("mlp", {}).get("wd"), 0)
        self.embed = split(sp.get("embed"), 0)
        self.head = (self.embed if cfg.tie_embeddings
                     else split(sp.get("lm_head"), 1))

    def use(self, w: torch.Tensor, spec) -> torch.Tensor:
        """``w`` all-gathered over every axis its spec shards it on, other
        than the model axis."""
        for d, e in enumerate(spec or ()):
            if e is not None and e != self.ctx.model_axis:
                w = C.gather_from(w, self.ctx.group(e), d)
        return w

    def use_tree(self, tree, specs):
        if specs is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.use_tree(v, specs[k]) for k, v in tree.items()}
        return self.use(tree, specs)

    def spec(self, *path):
        sp = self.specs
        for k in path:
            if sp is None:
                return None
            sp = sp[k]
        return sp


def _par(cfg: ModelConfig) -> Optional[_Par]:
    ctx = get_mesh_context()
    return None if ctx.mesh is None else _Par(ctx, cfg)


# ---------------------------------------------------------------------------
# Embedding / unembedding / rope helpers
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, batch, par=None):
    """The input features. Under a mesh whose layout splits the embedding's
    vocabulary over the model axis (``par.embed``), each rank looks up the
    tokens it holds rows for, zeroes the rest, and the parts are summed
    over the model group."""
    if cfg.input_mode != "tokens":
        return batch["embeds"].to(model_dtype(cfg))
    tokens = batch["tokens"]
    if par is None:
        return params["embed"][tokens]
    w = par.use(params["embed"], par.spec("embed"))
    if not par.embed:
        return w[tokens]
    t, own = _owned(tokens, par.r, w.shape[0])
    x = torch.where(own[..., None], w[t], torch.zeros((), dtype=w.dtype,
                                                      device=w.device))
    return C.reduce_from(x, par.group)


def _owned(ids: torch.Tensor, r: int, width: int):
    """Vocabulary ids as indices into rank ``r``'s ``width`` rows (clamped)
    and the mask of those it holds."""
    t = ids.long() - r * width
    own = (t >= 0) & (t < width)
    return t.clamp(0, width - 1), own


def _rope_tables(cfg: ModelConfig, positions, batch):
    if "a" not in cfg.block_pattern:
        return None, None
    if cfg.mrope:
        pos3 = batch.get("positions3")
        if pos3 is None:
            pos3 = positions[None].expand((3,) + tuple(positions.shape))
        return mrope_cos_sin(pos3, cfg.head_dim_, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)


def _unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _forward(cfg: ModelConfig, params, batch, par=None):
    """The training forward: embed, every layer (each under
    ``checkpoint`` when ``cfg.remat == "layer"``), the final norm. Returns
    (x (B, S, D), aux); aux, the MoE loss, is 0, since no ported layer has
    experts. ``par``: the mesh path (:class:`_Par`), or ``None``. Raises
    ``NotImplementedError`` for a config :func:`check_trainable` refuses."""
    check_trainable(cfg)
    x = _embed_inputs(cfg, params, batch, par)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = _rope_tables(cfg, positions, batch)
    for i, layer in enumerate(params["layers"]):
        lspec = None if par is None else par.spec("layers", i)
        if cfg.remat == "layer":
            x = checkpoint(_apply_group_train, layer, x, cos, sin, cfg, par,
                           lspec, use_reentrant=False)
        else:
            x = _apply_group_train(layer, x, cos, sin, cfg, par, lspec)
    norm = params["final_norm"]
    if par is not None:
        norm = par.use(norm, par.spec("final_norm"))
    x = rms_norm(x, norm, cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def _chunk_ce(cfg: ModelConfig, params, xc, lc, par=None):
    """Summed cross entropy of one chunk: its logits in float32, their
    log-sum-exp, less the gold logit.

    Under a mesh whose layout splits the vocabulary over the model axis
    (``par.head``), each rank forms its columns of the logits; the
    log-sum-exp takes the row maxima's all-reduce MAX and then the sum of
    the exponentials over the model group, and the gold logit comes from
    the rank that holds its column."""
    if par is None:
        logits = _unembed(cfg, params, xc).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return (logz - gold).sum()
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = par.use(params[name], par.spec(name))
    if par.head:
        xc = C.copy_to(xc, par.group)
    logits = (xc @ w.T if cfg.tie_embeddings else xc @ w).float()
    if not par.head:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return (logz - gold).sum()
    m = C.all_reduce(logits.detach().amax(dim=-1), par.group, "max")
    sumexp = C.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                           par.group)
    logz = m + torch.log(sumexp)
    t, own = _owned(lc, par.r, logits.shape[-1])
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    gold = C.reduce_from(torch.where(own, gold, torch.zeros_like(gold)),
                         par.group)
    return (logz - gold).sum()


def loss_fn(cfg: ModelConfig, params, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ MoE aux). batch: ``tokens`` (B, S) or
    ``embeds`` (B, S, D), ``labels`` (B, S), and for M-RoPE optionally
    ``positions3`` (3, B, S). Returns (loss, {"ce", "aux"}), float32
    scalars.

    The CE is computed in 8 chunks along the sequence when ``S % 8 == 0 and
    S >= 1024`` (else one), each under ``checkpoint``, so that only one
    chunk's (B, S/8, V) float32 logits exist at a time, recomputed in the
    backward, as in the reference.

    Under a training mesh (:func:`repro_torch.distributed.meshctx.
    mesh_context`, with the parameters' layout in its ``specs``),
    ``params`` and ``batch`` are this rank's shards, and the loss is the
    mean over this rank's rows."""
    par = _par(cfg)
    x, aux = _forward(cfg, params, batch, par)
    labels = batch["labels"]
    b, s, _ = x.shape
    n_chunks = 8 if (s % 8 == 0 and s >= 1024) else 1
    if n_chunks == 1:
        total = _chunk_ce(cfg, params, x, labels, par)
    else:
        c = s // n_chunks
        total = torch.zeros((), device=x.device)
        for i in range(n_chunks):
            total = total + checkpoint(
                _chunk_ce, cfg, params, x[:, i * c:(i + 1) * c],
                labels[:, i * c:(i + 1) * c], par, use_reentrant=False)
    ce = total / (b * s)
    loss = ce + MOE_AUX_COEF * aux
    return loss, dict(ce=ce, aux=aux)


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Any]:
    """``pos`` 0 and, for each layer, zeroed k/v buffers (B, Hkv,
    max_seq, hd) of an attention layer or the initial state of another
    mixer. ``device`` defaults to the card."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim_)

    def layer_cache(kind):
        if kind == "a":
            return dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))
        if kind == "m":
            return init_mamba_state(cfg, batch, dtype, dev)
        if kind == "M":
            return init_mlstm_state(cfg, batch, dev)
        return init_slstm_state(cfg, batch, dev)

    return dict(pos=0, layers=[layer_cache(cfg.layer_kind(i))
                               for i in range(cfg.num_layers)])


def _apply_layer_serve(layer, lcache, x, cos, sin, pos: int,
                       cfg: ModelConfig, kind: str):
    """One layer of ``_apply_group_serve``: its mixer on the layer's cache
    (attention writes k/v at ``pos``; another mixer runs its decode step
    on an input of length 1 and its forward otherwise, and its new state
    replaces the cache's), then the MLP."""
    if kind == "a":
        x, _ = _attn_apply(layer, x, cos, sin, cfg, cache=lcache, pos=pos)
    else:
        name, forward, step = _MIXERS[kind]
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        if x.shape[1] == 1:
            y, state = step(layer[name], lcache, h, cfg)
        else:
            y, state = forward(layer[name], h, cfg, return_state=True)
        lcache.update(state)
        x = x + y
    return _mlp_apply(layer, x, cfg)


def prefill(cfg: ModelConfig, params, batch, max_seq: int):
    """Returns (last-token logits (B, V) float32, cache). batch: ``tokens``
    (B, S) or ``embeds`` (B, S, D), and for M-RoPE optionally
    ``positions3`` (3, B, S)."""
    x = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = _rope_tables(cfg, positions, batch)
    cache = init_cache(cfg, b, max_seq, device=x.device)
    for i, (layer, lcache) in enumerate(zip(params["layers"],
                                            cache["layers"])):
        x = _apply_layer_serve(layer, lcache, x, cos, sin, 0, cfg,
                               cfg.layer_kind(i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x[:, -1:])[:, 0].float()
    cache["pos"] = s
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, tokens_or_embeds):
    """One decode step. tokens: (B, 1) integers (or embeds (B, 1, D)).
    Writes into ``cache`` in place and returns (logits (B, V) float32,
    cache) with ``pos`` advanced by one."""
    batch = ({"tokens": tokens_or_embeds} if cfg.input_mode == "tokens"
             else {"embeds": tokens_or_embeds})
    x = _embed_inputs(cfg, params, batch)
    b = x.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, device=x.device)
    cos, sin = _rope_tables(cfg, positions, batch)
    for i, (layer, lcache) in enumerate(zip(params["layers"],
                                            cache["layers"])):
        x = _apply_layer_serve(layer, lcache, x, cos, sin, pos, cfg,
                               cfg.layer_kind(i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)[:, 0].float()
    cache["pos"] = pos + 1
    return logits, cache
