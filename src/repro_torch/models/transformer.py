"""Port of ``repro/models/transformer.py``: parameter init
(``init_params`` :114 with ``_init_attn_slot`` :50, ``_init_mlp_slot``
:66 and ``_init_group`` :83, every block kind and MoE MLPs),
``_attn_apply`` (:137, the sharded-decode branch and the DP-only
attention's batch reshard included), ``_mlp_apply`` (:208, dense gated,
GELU and MoE),
``_embed_inputs`` (:252), ``_rope_tables`` (:258, M-RoPE included),
``_unembed`` (:270), and serving: ``init_cache`` (:351, every slot kind),
``_apply_group_serve`` (:372), ``prefill`` (:406) and ``decode_step``
(:429); and training: ``MOE_AUX_COEF`` (:39), ``_apply_group_train``
(:227) for every slot kind, ``_forward`` (:276) and ``loss_fn`` (:315).

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

Training runs the same layers: a Mamba, mLSTM or sLSTM mixer under
``norm1``, an MLP after 'a' and 'm' layers only, and the MoE aux losses
summed over the layers into the loss (``ce + MOE_AUX_COEF · aux``, the aux
in the gradient). The backward of the mixers is autograd through their
forward (the reference has no kernel for them). ``cfg.remat == "layer"``
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
axis, with the attention kernels running on each rank's local heads; the
MoE MLP runs the reference's mesh branches (:mod:`.moe`: dense, expert-TP
``tp_ragged`` or expert-parallel ``ep``, per ``cfg.moe_impl``). A Mamba,
mLSTM or sLSTM mixer gathers its leaves that the layout splits over the
model axis and computes whole on every model rank (a deliberate
divergence: GSPMD splits d_inner; the values are the same). The loss is
the mean over this rank's rows, with the aux as the reference combines it;
the trainer reduces the gradients over the data axes.

The two knobs the dry run compares (item 3.3), read from the context. With
``attn_dp_axes`` set (``attn_batch_reshard``) and q heads that do not tile
the model axis, the attention of a training forward runs on each model
rank's slice of the rows the rank holds (when they split evenly), with the
whole, replicated weights, and its output is gathered back over the model
axis: the reference's sharding constraint (:145-157) made explicit. The
attention leaves and ``norm1`` then each see a part of the batch, so they
pass :func:`~repro_torch.distributed.collectives.copy_to` and their
gradients are summed over the model group. With ``shard_activation_ckpt``
(the reference's constraint on the checkpointed carry, :284-297) and a
sequence that splits over the model axis, each checkpointed layer saves
only this rank's S / n_model slice of its input and all-gathers it back
before it is recomputed (:class:`_ShardedCheckpoint`). Neither changes a
value beyond the order of sums over the batch.

Serving under a mesh (the context's ``cache_specs``, from
:func:`repro_torch.distributed.sharding.cache_specs` at the global batch,
give the cache's layout): ``prefill`` and ``decode_step`` take this rank's
rows of the batch (all of them when the batch does not tile the data axes)
and run the same split layers, the logits gathered over the model axis
where the vocabulary is split. ``init_cache`` allocates this rank's slice:
its batch rows, its kv heads where they tile the model axis, and its part
of the sequence where the layout shards it (the data axes for a batch of
one, the model axis where the kv heads do not tile it); a Mamba or xLSTM
state is whole on every model rank. A prefill writes only the positions
of its rank's slice. A decode step with ``decode_seq_axes`` set runs
:func:`~repro_torch.models.layers.sharded_decode_attention` over those
axes; a cache whose sequence is split otherwise raises, since the port
never gathers a cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import collectives as C
from ..distributed.meshctx import MeshContext, _axes, get_mesh_context
from .config import ModelConfig
from .layers import (apply_rope, gen_device, gqa_attention, init_dense,
                     init_norm, mrope_cos_sin, rms_norm, rope_cos_sin,
                     sharded_decode_attention, swiglu_mlp)
from .moe import MoeMesh, dense_branch, init_moe_params, moe_ffn
from .ssm import (init_mamba_params, init_mamba_state, mamba_decode_step,
                  mamba_forward)
from .xlstm import (init_mlstm_params, init_mlstm_state, init_slstm_params,
                    init_slstm_state, mlstm_decode_step, mlstm_forward,
                    slstm_decode_step, slstm_forward)

__all__ = ["init_params", "loss_fn", "prefill", "decode_step", "init_cache",
           "model_dtype"]

MOE_AUX_COEF = 0.01


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
    a, norm1, xa = layer["attn"], layer["norm1"], x
    tp = par is not None and par.attn
    # the DP-only attention's batch reshard (module docstring)
    dp = (par is not None and par.attn_dp and not tp and cache is None
          and b % par.n == 0)
    if dp:
        a = {k: C.copy_to(w, par.group) for k, w in a.items()}
        norm1 = C.copy_to(norm1, par.group)
        xa = C.split_to(x, par.group, 0)
        b //= par.n
        cos, sin = (t.narrow(0, par.r * b, b) for t in (cos, sin))
    h = rms_norm(xa, norm1, cfg.norm_eps)
    wk, wv = a["wk"], a["wv"]
    qn, kn = a.get("q_norm"), a.get("k_norm")
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
    rep = cfg.num_heads // cfg.num_kv_heads
    k_all, v_all = k, v  # every kv head this rank computed, for its cache
    if tp and not par.kv_split:
        k, v = _local_kv(k, v, par.r, hq, rep)
    chunks = dict(q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    if cache is not None and s == 1 and par is not None \
            and par.ctx.decode_seq_axes:
        att = _sharded_decode(q, k_all, v_all, cache, pos, par, tp)
    elif cache is not None:
        s_loc = cache["k"].shape[2]
        start, total = ((0, s_loc) if par is None
                        else par.seq_slice(s_loc))
        _write_kv(cache, k_all, v_all, pos, start, total)
        if s == 1:
            # decode: read the whole (masked) buffer — the HBM-bound path
            if par is not None:
                par.check_seq_whole()
            ck, cv = cache["k"], cache["v"]
            if tp and not par.kv_split:
                ck, cv = _local_kv(ck, cv, par.r, hq, rep)
            att = gqa_attention(q, ck, cv, causal=False,
                                kv_valid_len=pos + s, impl="plain", **chunks)
        else:
            # prefill: attend causally over the fresh k/v, not the buffer
            att = gqa_attention(q, k, v, causal=True, **chunks)
    else:
        att = gqa_attention(q, k, v, causal=causal, **chunks)
    out = att.transpose(1, 2).reshape(b, s, hq * hd) @ a["wo"]
    if tp:
        out = C.reduce_from(out, par.group)
    if dp:
        out = C.gather_whole(out, par.group, 0)
    return x + out, cache


def _write_kv(cache, k, v, pos: int, start: int, total: int) -> None:
    """Write k/v (B, H, s, hd) of positions ``[pos, pos + s)`` into a cache
    slice holding positions ``[start, start + S)`` of ``total``, in place;
    positions outside the slice are not stored."""
    s, s_loc = k.shape[2], cache["k"].shape[2]
    if pos + s > total:
        raise ValueError(f"the cache holds {total} positions; cannot write "
                         f"{s} at {pos}")
    lo, hi = max(pos, start), min(pos + s, start + s_loc)
    if lo < hi:
        cache["k"][:, :, lo - start:hi - start] = k[:, :, lo - pos:hi - pos]
        cache["v"][:, :, lo - start:hi - start] = v[:, :, lo - pos:hi - pos]


def _sharded_decode(q, k, v, cache, pos: int, par, tp: bool):
    """The decode branch over a sequence-sharded cache: q (B, Hq_l, 1, hd)
    this rank's q heads, k/v (B, Hkv_c, 1, hd) the new position's kv heads
    the cache holds. Where the cache holds every kv head but the q heads
    are split over the model axis, the q heads are gathered over it first
    and this rank's heads taken from the output."""
    ctx = par.ctx
    par.check_seq_axes()
    total = cache["k"].shape[2] * ctx.size(ctx.decode_seq_axes)
    if pos >= total:
        raise ValueError(f"the cache holds {total} positions; cannot write "
                         f"1 at {pos}")
    gather_q = tp and not par.kv_split
    if gather_q:
        q = C.all_gather(q, par.group, 1)
    rep = q.shape[1] // cache["k"].shape[1]
    att, _, _ = sharded_decode_attention(
        q, cache["k"], cache["v"], k, v, pos, ctx=ctx,
        seq_axes=ctx.decode_seq_axes, rep=rep)
    if gather_q:
        hq_l = q.shape[1] // par.n
        att = att[:, par.r * hq_l:(par.r + 1) * hq_l]
    return att


def _local_kv(k, v, r: int, hq_l: int, rep: int):
    """The kv heads (B, Hkv, S, D) that model rank ``r``'s ``hq_l`` q heads
    read (q head i reads kv head i // rep): a run of heads when each serves
    whole groups of the local q heads, else one head per q head."""
    idx = [(r * hq_l + j) // rep for j in range(hq_l)]
    if hq_l % rep == 0 or rep % hq_l == 0:
        return k[:, idx[0]:idx[-1] + 1], v[:, idx[0]:idx[-1] + 1]
    ix = torch.tensor(idx, device=k.device)
    return k.index_select(1, ix), v.index_select(1, ix)


def _mlp_apply(layer, x, cfg: ModelConfig, par=None, mspec=None):
    """Post-mixer MLP: dense (gated SwiGLU or tanh-approximate GELU), or
    MoE (:func:`~repro_torch.models.moe.moe_ffn`). Returns (x, the float32
    MoE aux loss, or ``None`` for a dense MLP or none). Under a mesh whose
    layout splits the hidden width (``mspec``, the MLP's specs): ``wg``,
    ``wu``, ``wi`` column-parallel, ``wd`` row-parallel with its partial
    products summed over the model group; an MoE MLP takes the reference's
    mesh branches (:meth:`_Par.moe`)."""
    if "mlp" not in layer:
        return x, None
    h = rms_norm(x, layer["norm2"], cfg.norm_eps)
    mlp = layer["mlp"]
    if "router" in mlp:
        if par is None:
            y, aux = moe_ffn(mlp, h, cfg)
        else:
            y, aux = par.moe(mlp, mspec, h, cfg)
        return x + y, aux
    tp = par is not None and par.split(mspec["wd"], 0)
    if tp:
        h = C.copy_to(h, par.group)
    if cfg.mlp_gated:
        y = swiglu_mlp(h, mlp["wg"], mlp["wu"], mlp["wd"])
    else:
        u = F.gelu((h @ mlp["wi"]).float(), approximate="tanh").to(h.dtype)
        y = u @ mlp["wd"]
    if tp:
        y = C.reduce_from(y, par.group)
    return x + y, None


def _apply_group_train(layer, x, cos, sin, cfg: ModelConfig, kind: str,
                       par=None, lspec=None):
    """One layer of the training forward (the reference's group slot):
    its mixer (attention, or a Mamba, mLSTM or sLSTM mixer under
    ``norm1``), then, after 'a' and 'm' layers, the MLP. Returns (x, the
    layer's MoE aux loss or ``None``). Under a mesh the layer's FSDP-sharded leaves are
    gathered first, here, so that a checkpointed layer gathers them again
    when it is recomputed; a mixer's leaves are gathered whole."""
    if par is not None:
        layer = {k: par.use_tree(v, lspec[k], whole=k in _WHOLE)
                 for k, v in layer.items()}
    if kind == "a":
        x, _ = _attn_apply(layer, x, cos, sin, cfg, par=par)
    else:
        name, forward, _ = _MIXERS[kind]
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        x = x + forward(layer[name], h, cfg)
    if kind not in ("a", "m"):
        return x, None
    return _mlp_apply(layer, x, cfg, par=par,
                      mspec=None if lspec is None else lspec.get("mlp"))


#: the mixers a mesh computes whole on every model rank
_WHOLE = ("mamba", "mlstm", "slstm")


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------

class _Par:
    """The model's view of an active training mesh: the parameters'
    layout (the context's ``specs``), the model group, its width ``n`` and
    this rank's index ``r`` on it, the data group and its width, and which
    products the layout splits over the model axis. A product is split
    where its weight's spec puts the model axis (a bare name) on a
    dimension; every other sharded dimension (FSDP: a tuple of axes) is
    all-gathered where the leaf is used."""

    def __init__(self, ctx: MeshContext, cfg: ModelConfig,
                 serving: bool = False):
        self.ctx, self.specs = ctx, ctx.specs
        ma = ctx.model_axis
        self.has_model = ma in tuple(ctx.mesh.mesh_dim_names)
        self.group = ctx.group(ma) if self.has_model else None
        self.n = ctx.size(ma) if self.has_model else 1
        self.r = ctx.index(ma) if self.has_model else 0
        self.data_group = ctx.group(ctx.data_axes)
        self.n_data = ctx.size(ctx.data_axes)
        # serving: the axes the cache's sequence is split over; a batch
        # that does not tile the data axes is whole on every data rank, so
        # the MoE counts its tokens once (no data group)
        self.seq_axes: Tuple[str, ...] = ()
        if serving:
            cs = ctx.cache_specs
            if cs is None:
                raise ValueError(
                    "serving under a mesh needs MeshContext.cache_specs "
                    "(sharding.cache_specs at the global batch)")
            if next(iter(cs["layers"][0].values()))[0] is None:
                self.data_group, self.n_data = None, 1
            kv = next((l["k"] for l in cs["layers"] if "k" in l), None)
            if kv is not None:
                self.seq_axes = ctx._ordered(kv[2])

        sp = self.specs or {}
        layers = sp.get("layers", []) if sp else []
        attn = next((l["attn"] for l in layers if "attn" in l), {})
        self.attn = self.split(attn.get("wq"), 1)
        self.kv_split = self.split(attn.get("wk"), 1)
        self.embed = self.split(sp.get("embed"), 0)
        self.head = (self.embed if cfg.tie_embeddings
                     else self.split(sp.get("lm_head"), 1))
        # the plan's knobs (module docstring): the DP-only attention's batch
        # reshard over the model group, and checkpoints cut along S over it
        self.attn_dp = self.has_model and ma in (ctx.attn_dp_axes or ())
        self.ckpt_shard = self.has_model and ctx.shard_activation_ckpt

    def seq_slice(self, s_loc: int) -> Tuple[int, int]:
        """(first position, whole length) of a cache slice of ``s_loc``
        positions on this rank."""
        if not self.seq_axes:
            return 0, s_loc
        return (self.ctx.index(self.seq_axes) * s_loc,
                s_loc * self.ctx.size(self.seq_axes))

    def _wide(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in self.ctx._ordered(axes)
                     if self.ctx.size(a) > 1)

    def check_seq_whole(self) -> None:
        """Raise unless the cache's sequence is whole on this rank."""
        if self._wide(self.seq_axes):
            raise ValueError(
                f"the cache's sequence is split over {self.seq_axes}: "
                f"decode needs MeshContext.decode_seq_axes (the cache is "
                f"never gathered)")

    def check_seq_axes(self) -> None:
        """Raise unless ``decode_seq_axes`` split the sequence as the
        cache's layout does (axes of width 1 aside)."""
        want = self._wide(self.ctx.decode_seq_axes)
        if want != self._wide(self.seq_axes):
            raise ValueError(
                f"decode_seq_axes {self.ctx.decode_seq_axes} do not split "
                f"the cache's sequence, which its layout splits over "
                f"{self.seq_axes or 'no axis'}")

    def split(self, spec, dim: int) -> bool:
        """Whether ``spec`` splits dimension ``dim`` over the model axis."""
        return (self.has_model and spec is not None
                and spec[dim] == self.ctx.model_axis)

    def use(self, w: torch.Tensor, spec, whole: bool = False
            ) -> torch.Tensor:
        """``w`` all-gathered over every axis its spec shards it on, other
        than the model axis; with ``whole``, over the model axis too, for a
        computation every model rank makes alike (its gradient is then cut
        back to this rank's slice, not summed)."""
        ma = self.ctx.model_axis
        for d, e in enumerate(spec or ()):
            if e is not None and e != ma:
                w = C.gather_from(w, self.ctx.group(e), d)
        if whole:
            for d, e in enumerate(spec or ()):
                if e == ma:
                    w = C.gather_whole(w, self.group, d)
        return w

    def use_tree(self, tree, specs, whole: bool = False):
        if specs is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.use_tree(v, specs[k], whole)
                    for k, v in tree.items()}
        return self.use(tree, specs, whole)

    def spec(self, *path):
        sp = self.specs
        for k in path:
            if sp is None:
                return None
            sp = sp[k]
        return sp

    def moe(self, mlp, mspec, h, cfg: ModelConfig):
        """The MoE MLP over the mesh (``mlp``: this rank's leaves, FSDP
        dimensions gathered). The dense branch and ``tp_ragged`` take the
        layout's ``F`` slices; ``ep``'s capacity path reshards them to this
        rank's experts at their whole ``F`` (:meth:`own_experts`)."""
        split = self.split(mspec["wg"], 2)
        mesh = MoeMesh(self.group if split else None, self.n if split else 1,
                       self.data_group, self.n_data)
        b, s, _ = h.shape
        if cfg.moe_impl == "ep" and not dense_branch(b * s, mesh):
            if mesh.model_group is None:
                raise ValueError("moe_impl='ep' needs a model axis that "
                                 "splits the experts' hidden width")
            e = cfg.num_experts
            if e % self.n:
                raise ValueError(f"{e} experts do not split over {self.n} "
                                 f"model ranks")
            mlp = dict(mlp, **{k: self.own_experts(mlp[k], 2 if k != "wd"
                                                   else 1)
                               for k in ("wg", "wu", "wd")})
        return moe_ffn(mlp, h, cfg, mesh)

    def own_experts(self, w: torch.Tensor, f_dim: int) -> torch.Tensor:
        """Every expert's ``F`` slice (E, ..., F/n on ``f_dim``) resharded
        to this rank's E/n experts whole along ``F``, by one all-to-all over
        the model group: GSPMD's reshard from the layout to ``ep``'s
        ``P(model, None, None)``. Each rank moves and holds 1/n of the
        experts; the gradient goes back by the reverse all-to-all."""
        n, e = self.n, w.shape[0]
        blocks = C.exchange(w.reshape((n, e // n) + tuple(w.shape[1:])),
                            self.group)
        # blocks[j]: this rank's experts, model rank j's F slice
        return blocks.movedim(0, f_dim).flatten(f_dim, f_dim + 1)


def _par(cfg: ModelConfig, serving: bool = False) -> Optional[_Par]:
    ctx = get_mesh_context()
    return None if ctx.mesh is None else _Par(ctx, cfg, serving)


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
    (x (B, S, D), aux), aux the float32 sum of the MoE layers' aux losses.
    ``par``: the mesh path (:class:`_Par`), or ``None``."""
    x = _embed_inputs(cfg, params, batch, par)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = _rope_tables(cfg, positions, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sharded = par is not None and par.ckpt_shard and s % par.n == 0
    for i, layer in enumerate(params["layers"]):
        lspec = None if par is None else par.spec("layers", i)
        args = (layer, x, cos, sin, cfg, cfg.layer_kind(i), par, lspec)
        if cfg.remat == "layer" and sharded:
            x, a = _ShardedCheckpoint.run(*args)
        elif cfg.remat == "layer":
            x, a = checkpoint(_apply_group_train, *args, use_reentrant=False)
        else:
            x, a = _apply_group_train(*args)
        if a is not None:
            aux = aux + a
    norm = params["final_norm"]
    if par is not None:
        norm = par.use(norm, par.spec("final_norm"))
    x = rms_norm(x, norm, cfg.norm_eps)
    return x, aux


def _tensors(tree) -> list:
    """The tensors of a layer's dict of dicts, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree`` with its tensors replaced, in :func:`_tensors`' order, by
    the items of the iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


class _ShardedCheckpoint(torch.autograd.Function):
    """A checkpointed layer whose saved input is this rank's slice of the
    sequence over the model group (``shard_activation_ckpt``): the forward
    runs the layer without a graph and keeps x[:, r·S/n:(r+1)·S/n]; the
    backward all-gathers the slices into the whole input (the same on
    every model rank), recomputes the layer with a graph and returns its
    gradients, as ``checkpoint`` does with the whole input saved."""

    @staticmethod
    def run(layer, x, cos, sin, cfg, kind, par, lspec):
        """``_apply_group_train(layer, x, ...)`` so checkpointed; returns
        (x, aux or ``None``)."""
        def apply(xx, leaves):
            return _apply_group_train(_rebuild(layer, iter(leaves)), xx,
                                      cos, sin, cfg, kind, par, lspec)

        return _ShardedCheckpoint.apply(apply, par, x, *_tensors(layer))

    @staticmethod
    def forward(ctx, apply, par, x, *leaves):
        ctx.layer_fn, ctx.par = apply, par
        w = x.shape[1] // par.n
        ctx.save_for_backward(x.narrow(1, par.r * w, w).contiguous(),
                              *leaves)
        return apply(x, leaves)

    @staticmethod
    def backward(ctx, gy, gaux):
        xs, *leaves = ctx.saved_tensors
        x = C.all_gather(xs, ctx.par.group, 1).detach().requires_grad_(
            ctx.needs_input_grad[2])
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        with torch.enable_grad():
            y, aux = ctx.layer_fn(x, leaves)
        outs, grads = [y], [gy]
        if aux is not None and gaux is not None:
            outs.append(aux)
            grads.append(gaux)
        want = [t for t in [x] + leaves if t.requires_grad]
        got = iter(torch.autograd.grad(outs, want, grads, allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in [x] + leaves)


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

def _split_dim(n: int, entry, ctx: MeshContext) -> int:
    """This rank's length of a dimension of ``n`` laid out by ``entry``."""
    if not entry:
        return n
    w = ctx.size(entry)
    if n % w:
        raise ValueError(f"a cache dimension of {n} does not split over "
                         f"{w} ranks of {_axes(entry)}")
    return n // w


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Any]:
    """``pos`` 0 and, for each layer, zeroed k/v buffers (B, Hkv,
    max_seq, hd) of an attention layer or the initial state of another
    mixer. ``device`` defaults to the card. Under a mesh (the context's
    ``cache_specs``), ``batch`` is the global batch and the buffers are
    this rank's slice of them; the other mixers' states are whole over the
    model axis."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)
    b, hkv, s = batch, cfg.num_kv_heads, max_seq
    ctx = get_mesh_context()
    if ctx.mesh is not None:
        if ctx.cache_specs is None:
            raise ValueError(
                "a cache under a mesh needs MeshContext.cache_specs "
                "(sharding.cache_specs at the global batch)")
        lay = ctx.cache_specs["layers"]
        b = _split_dim(batch, next(iter(lay[0].values()))[0], ctx)
        kv = next((l["k"] for l in lay if "k" in l), None)
        if kv is not None:
            hkv = _split_dim(hkv, kv[1], ctx)
            s = _split_dim(max_seq, kv[2], ctx)
    shape = (b, hkv, s, cfg.head_dim_)

    def layer_cache(kind):
        if kind == "a":
            return dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))
        if kind == "m":
            return init_mamba_state(cfg, b, dtype, dev)
        if kind == "M":
            return init_mlstm_state(cfg, b, dev)
        return init_slstm_state(cfg, b, dev)

    return dict(pos=0, layers=[layer_cache(cfg.layer_kind(i))
                               for i in range(cfg.num_layers)])


def _apply_layer_serve(layer, lcache, x, cos, sin, pos: int,
                       cfg: ModelConfig, kind: str, par=None, lspec=None):
    """One layer of ``_apply_group_serve``: its mixer on the layer's cache
    (attention writes k/v at ``pos``; another mixer runs its decode step
    on an input of length 1 and its forward otherwise, and its new state
    replaces the cache's), then the MLP. Under a mesh the layer's
    FSDP-sharded leaves are gathered first, a mixer's whole."""
    if par is not None:
        layer = {k: par.use_tree(v, lspec[k], whole=k in _WHOLE)
                 for k, v in layer.items()}
    if kind == "a":
        x, _ = _attn_apply(layer, x, cos, sin, cfg, cache=lcache, pos=pos,
                           par=par)
    else:
        name, forward, step = _MIXERS[kind]
        h = rms_norm(x, layer["norm1"], cfg.norm_eps)
        if x.shape[1] == 1:
            y, state = step(layer[name], lcache, h, cfg)
        else:
            y, state = forward(layer[name], h, cfg, return_state=True)
        lcache.update(state)
        x = x + y
    return _mlp_apply(layer, x, cfg, par=par,
                      mspec=None if lspec is None else lspec.get("mlp"))[0]


def _serve_layers(cfg: ModelConfig, params, cache, x, cos, sin, pos: int,
                  par) -> torch.Tensor:
    """Every layer on its cache, then the final norm."""
    for i, (layer, lcache) in enumerate(zip(params["layers"],
                                            cache["layers"])):
        lspec = None if par is None else par.spec("layers", i)
        x = _apply_layer_serve(layer, lcache, x, cos, sin, pos, cfg,
                               cfg.layer_kind(i), par, lspec)
    norm = params["final_norm"]
    if par is not None:
        norm = par.use(norm, par.spec("final_norm"))
    return rms_norm(x, norm, cfg.norm_eps)


def _serve_logits(cfg: ModelConfig, params, x, par) -> torch.Tensor:
    """Float32 logits (B, V) of ``x`` (B, 1, D); under a mesh that splits
    the vocabulary over the model axis, each rank's columns are gathered
    over it."""
    if par is None:
        return _unembed(cfg, params, x)[:, 0].float()
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = par.use(params[name], par.spec(name))
    logits = (x @ w.T if cfg.tie_embeddings else x @ w)[:, 0].float()
    if par.head:
        logits = C.all_gather(logits, par.group, 1)
    return logits


def prefill(cfg: ModelConfig, params, batch, max_seq: int):
    """Returns (last-token logits (B, V) float32, cache). batch: ``tokens``
    (B, S) or ``embeds`` (B, S, D), and for M-RoPE optionally
    ``positions3`` (3, B, S). Under a mesh: this rank's rows, logits and
    cache slice (module docstring)."""
    par = _par(cfg, serving=True)
    x = _embed_inputs(cfg, params, batch, par)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = _rope_tables(cfg, positions, batch)
    cache = init_cache(cfg, b * (1 if par is None else par.n_data), max_seq,
                       device=x.device)
    x = _serve_layers(cfg, params, cache, x, cos, sin, 0, par)
    logits = _serve_logits(cfg, params, x[:, -1:], par)
    cache["pos"] = s
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, tokens_or_embeds):
    """One decode step. tokens: (B, 1) integers (or embeds (B, 1, D)).
    Writes into ``cache`` in place and returns (logits (B, V) float32,
    cache) with ``pos`` advanced by one. Under a mesh: this rank's rows
    and cache slice; with ``decode_seq_axes`` set, attention reads a
    sequence-sharded cache through ``sharded_decode_attention``."""
    par = _par(cfg, serving=True)
    batch = ({"tokens": tokens_or_embeds} if cfg.input_mode == "tokens"
             else {"embeds": tokens_or_embeds})
    x = _embed_inputs(cfg, params, batch, par)
    b = x.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, device=x.device)
    cos, sin = _rope_tables(cfg, positions, batch)
    x = _serve_layers(cfg, params, cache, x, cos, sin, pos, par)
    logits = _serve_logits(cfg, params, x, par)
    cache["pos"] = pos + 1
    return logits, cache
