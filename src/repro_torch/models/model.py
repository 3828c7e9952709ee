"""Model assembly for all six LM families (the port's counterpart of
``repro/models/model.py``).

Parameters keep the JAX package's tree: nested dicts with per-layer leaves
STACKED on a leading L, one ``nn.Parameter`` (no gradient) a leaf.  The
layers run in a Python loop over per-layer views of those leaves; serving
takes no gradients, so the JAX package's ``jax.checkpoint`` and
``SCAN_UNROLL`` have no counterpart.

Entry points (uniform across families; ``batch`` holds ``tokens`` (B, T)
and, per family, ``patch_embeds`` (vlm), ``enc_embeds`` (encdec) and
``labels`` (the loss)):

    LM(cfg, device=None)               placed on ``cuda`` unless told "cpu"
    init(generator) / load_params(tree)
    forward(batch)                     -> (logits, aux)
    loss(batch)                        -> (loss, {"ce", "aux"})  (the value)
    init_cache(batch_size, max_seq)    -> cache
    prefill(batch, max_seq)            -> (logits_last, cache)
    decode_step(token, cache)          -> (logits, cache)

A cache's ``pos`` is a 0-d int64 tensor on the model's device, so a decode
step reads nothing back to the host.  Its KV tensors are written in place
(the returned cache shares them; clone a cache to decode from it twice);
recurrent states come back as new tensors.  Decode attention runs the
hand-written kernel on the card (``attention.decode_attention``);
``decode_step(..., plain=True)`` runs its plain form instead, for holding
the two against each other.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of a parameter tree, in key order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def _map_named(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(its dotted name)``."""
    return {k: _map_named(fn, v, f"{prefix}{k}.") if isinstance(v, dict)
            else fn(prefix + k) for k, v in tree.items()}


def _stack(n: int, make):
    """``make()`` builds one layer's tree; returns the n layers' trees
    stacked on a leading axis, holding at most one layer beside the stack
    (a single layer is a view, no copy)."""
    first = make()
    if n == 1:
        return _map(lambda a: a.unsqueeze(0), first)
    out = _map(lambda a: a.new_empty((n, *a.shape)), first)

    def put(i, layer):
        for (_, dst), (_, src) in zip(_leaves(out), _leaves(layer)):
            dst[i].copy_(src)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, make())
    return out


def _shared_cfg(cfg: ArchConfig) -> ArchConfig:
    """zamba2's shared block: attention over concat([h, embed]) (2d)."""
    return cfg.replace(head_dim=2 * cfg.d_model // cfg.n_heads)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # as tensors report it ("cuda:0", not "cuda")
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.params = None
        self._views = {}

    # ------------------------------------------------------------- init --
    def init(self, generator: torch.Generator) -> dict:
        """Random weights drawn from ``generator`` (on its own device, then
        placed on the model's), at the JAX package's shapes, dtypes and
        scales; loaded and returned."""
        cfg, gen, dev = self.cfg, generator, self.device
        pdt = _DTYPES[cfg.param_dtype]
        out_scale = 1.0 / max(1.0, (2.0 * cfg.n_layers) ** 0.5)
        p: dict = {
            "embed": cm.embed_params(gen, cfg.vocab_padded, cfg.d_model, pdt,
                                     dev),
            "head": cm.embed_params(gen, cfg.vocab_padded, cfg.d_model, pdt,
                                    dev),
            "final_norm": cm.norm_params(cfg, cfg.d_model, pdt, dev),
        }

        def dense_layer():
            return {
                "attn": attn.attn_params(gen, cfg, dtype=pdt,
                                         out_scale=out_scale, device=dev),
                "mlp": cm.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                     pdt, bias=cfg.bias, out_scale=out_scale,
                                     device=dev),
                "ln1": cm.norm_params(cfg, cfg.d_model, pdt, dev),
                "ln2": cm.norm_params(cfg, cfg.d_model, pdt, dev),
            }

        fam = cfg.family
        if fam in ("dense", "vlm"):
            p["layers"] = _stack(cfg.n_layers, dense_layer)
        elif fam == "moe":
            def moe_layer():
                return {
                    "attn": attn.attn_params(gen, cfg, dtype=pdt,
                                             out_scale=out_scale, device=dev),
                    "moe": moe_mod.moe_params(gen, cfg, pdt, out_scale, dev),
                    "ln1": cm.norm_params(cfg, cfg.d_model, pdt, dev),
                    "ln2": cm.norm_params(cfg, cfg.d_model, pdt, dev),
                }
            p["layers"] = _stack(cfg.n_layers, moe_layer)
        elif fam == "ssm":
            p["layers"] = _stack(cfg.n_layers, lambda: rk.rwkv6_params(
                gen, cfg, pdt, out_scale, dev))
        elif fam == "hybrid":
            p["layers"] = _stack(cfg.n_layers, lambda: mb.mamba2_params(
                gen, cfg, pdt, out_scale, dev))
            scfg = _shared_cfg(cfg)
            p["shared"] = {
                "attn": attn.attn_params(gen, scfg, d_model=2 * cfg.d_model,
                                         dtype=pdt, out_scale=out_scale,
                                         device=dev),
                "ln": cm.norm_params(cfg, 2 * cfg.d_model, pdt, dev),
                "proj": cm.normal(gen, (scfg.n_heads * scfg.hd, cfg.d_model),
                                  pdt, 0.02 * out_scale, dev),
                "mlp": cm.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                     pdt, out_scale=out_scale, device=dev),
                "ln2": cm.norm_params(cfg, cfg.d_model, pdt, dev),
            }
        elif fam == "encdec":
            p["enc_layers"] = _stack(cfg.n_enc_layers, dense_layer)
            p["enc_norm"] = cm.norm_params(cfg, cfg.d_model, pdt, dev)

            def dec_layer():
                d = dense_layer()
                d["cross"] = attn.attn_params(gen, cfg, dtype=pdt,
                                              out_scale=out_scale, device=dev)
                d["ln3"] = cm.norm_params(cfg, cfg.d_model, pdt, dev)
                return d
            p["layers"] = _stack(cfg.n_layers, dec_layer)
        else:
            raise ValueError(fam)
        self.load_params(p)
        return self.params

    def load_params(self, tree: dict) -> "LM":
        """Take ``tree`` (the JAX tree's keys, tensors on the model's
        device) as the weights: each leaf becomes an ``nn.Parameter``
        without a gradient, sharing the leaf's storage."""
        for name in list(self._parameters):
            delattr(self, name)
        for name, leaf in _leaves(tree):
            if leaf.device != self.device:
                raise ValueError(f"{name} is on {leaf.device}, the model on "
                                 f"{self.device}")
            self.register_parameter(name.replace(".", "__"),
                                    nn.Parameter(leaf, requires_grad=False))
        # A module-level walk: a nested recursive closure over ``self``
        # would hold the model, and its weights, in a cycle until gc runs.
        self.params = _map_named(
            lambda name: self._parameters[name.replace(".", "__")], tree)
        self._views = {}
        return self

    def _apply(self, fn, recurse=True):
        self._views = {}
        return super()._apply(fn, recurse)

    def _layers(self, key: str = "layers") -> list:
        """Per-layer views of ``params[key]``'s stacked leaves, made once."""
        if key not in self._views:
            stacked = self.params[key]
            n = next(_leaves(stacked))[1].shape[0]
            self._views[key] = [_map(lambda a, i=i: a[i], stacked)
                                for i in range(n)]
        return self._views[key]

    # ------------------------------------------------------- positional --
    def _cos_sin(self, positions=None, pos3=None):
        cfg = self.cfg
        if cfg.mrope_sections:
            return cm.mrope_freqs(cfg.hd, cfg.rope_theta, pos3,
                                  cfg.mrope_sections)
        return cm.rope_freqs(cfg.hd, cfg.rope_theta, positions)

    def _embed(self, batch):
        """Token embeddings in the compute dtype; for a vlm the patch
        embeddings prepended and the M-RoPE ids.  Returns (x, n_pre,
        cos_sin) with cos_sin None for the ssm and hybrid families."""
        cfg = self.cfg
        cdt = _DTYPES[cfg.compute_dtype]
        tokens = batch["tokens"]
        b, t = tokens.shape
        x = cm.embed_lookup(self.params["embed"], tokens).to(cdt)
        pos = torch.arange(t, device=x.device)
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(cdt)          # (B, P, D)
            n_pre = patches.shape[1]
            x = torch.cat([patches, x], dim=1)
            side = int(n_pre ** 0.5) or 1
            grid = torch.arange(n_pre, device=x.device)
            img3 = torch.stack([torch.zeros_like(grid), grid // side,
                                grid % side])
            txt3 = cm.text_pos3((n_pre + pos).expand(b, t))
            pos3 = torch.cat([img3[None].expand(b, 3, n_pre), txt3], dim=-1)
            return x, n_pre, self._cos_sin(pos3=pos3)
        if cfg.family in ("ssm", "hybrid"):    # zamba2's shared block
            return x, 0, None                  # takes its own rotary table
        return x, 0, self._cos_sin(pos)

    # --------------------------------------------------------- forward ---
    def _dense_block(self, p, x, cos_sin):
        cfg = self.cfg
        if cfg.parallel_block:
            h = cm.apply_norm(cfg, x, p["ln1"])
            x = x + attn.attention_train(p["attn"], cfg, h, cos_sin) \
                + cm.mlp_apply(p["mlp"], h, cfg.act)
            return x, None
        x = x + attn.attention_train(
            p["attn"], cfg, cm.apply_norm(cfg, x, p["ln1"]), cos_sin)
        if "moe" in p:
            y, aux = moe_mod.moe_apply(
                p["moe"], cfg, cm.apply_norm(cfg, x, p["ln2"]))
            return x + y, aux
        x = x + cm.mlp_apply(
            p["mlp"], cm.apply_norm(cfg, x, p["ln2"]), cfg.act)
        return x, None

    def _shared_block(self, x, x0, cos_sin, attend=None):
        """zamba2's weight-shared attention block on concat([h, embed]).
        ``attend(q, k, v)`` gives the attention output (B, T, H, hd):
        causal flash attention by default; prefill writes the cache first,
        decode attends over it."""
        cfg, sh = self.cfg, self.params["shared"]
        b, t = x.shape[:2]
        hcat = cm.apply_norm(cfg, torch.cat([x, x0], dim=-1), sh["ln"])
        q, k, v = attn.qkv(sh["attn"], _shared_cfg(cfg), hcat)
        q = cm.apply_rope(q, *cos_sin)
        k = cm.apply_rope(k, *cos_sin)
        o = (attend or attn.flash_attention)(q, k, v)
        x = x + o.reshape(b, t, -1) @ sh["proj"].to(x.dtype)
        return x + cm.mlp_apply(sh["mlp"], cm.apply_norm(cfg, x, sh["ln2"]),
                                cfg.act)

    def _backbone(self, x, cos_sin):
        """The layer loop of ``forward``.  Returns (x, aux_loss)."""
        cfg = self.cfg
        fam = cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam in ("dense", "vlm", "moe"):
            for p_l in self._layers():
                x, a = self._dense_block(p_l, x, cos_sin)
                if a is not None:
                    aux = aux + a
            return x, aux
        if fam == "ssm":
            st = rk.rwkv6_init_state(cfg, x.shape[0], x.device)
            for p_l in self._layers():
                x, _ = rk.rwkv6_block(p_l, cfg, x, st)
            return x, aux
        if fam == "hybrid":
            x0 = x
            period = cfg.shared_attn_period
            layers = self._layers()
            scs = cm.rope_freqs(_shared_cfg(cfg).hd, cfg.rope_theta,
                                torch.arange(x.shape[1], device=x.device))
            for gi in range(cfg.n_layers // period):
                for p_l in layers[gi * period:(gi + 1) * period]:
                    x = x + mb.mamba2_apply(p_l, cfg, x)
                x = self._shared_block(x, x0, scs)
            return x, aux
        raise ValueError(fam)

    def _encode(self, enc_embeds):
        """Encoder stack (full self-attention) -> hidden states."""
        cfg = self.cfg
        t = enc_embeds.shape[1]
        cos_sin = cm.rope_freqs(cfg.hd, cfg.rope_theta,
                                torch.arange(t, device=enc_embeds.device))
        x = enc_embeds
        for p_l in self._layers("enc_layers"):
            x = x + attn.attention_train(
                p_l["attn"], cfg, cm.apply_norm(cfg, x, p_l["ln1"]),
                cos_sin, causal=False)
            x = x + cm.mlp_apply(
                p_l["mlp"], cm.apply_norm(cfg, x, p_l["ln2"]), cfg.act)
        return cm.apply_norm(cfg, x, self.params["enc_norm"])

    def _cross(self, p_l, x, enc_hidden):
        """Cross-attention of the decoder stream x over the encoder's
        hidden states, projected with this layer's k/v.  Returns
        (x, ck, cv)."""
        cfg = self.cfg
        hq = cm.apply_norm(cfg, x, p_l["ln3"])
        q, _, _ = attn.qkv(p_l["cross"], cfg, hq)
        _, ck, cv = attn.qkv(p_l["cross"], cfg, enc_hidden)
        o = attn.flash_attention(q, ck, cv, causal=False)
        x = x + o.reshape(*x.shape[:2], -1) @ p_l["cross"]["wo"].to(x.dtype)
        return x, ck, cv

    def _backbone_encdec(self, x, cos_sin, enc_hidden):
        cfg = self.cfg
        for p_l in self._layers():
            h = cm.apply_norm(cfg, x, p_l["ln1"])
            x = x + attn.attention_train(p_l["attn"], cfg, h, cos_sin)
            x, _, _ = self._cross(p_l, x, enc_hidden)
            x = x + cm.mlp_apply(
                p_l["mlp"], cm.apply_norm(cfg, x, p_l["ln2"]), cfg.act)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    @torch.no_grad()
    def forward(self, batch):
        """Logits for the full sequence.  Returns (logits, aux)."""
        cfg = self.cfg
        x, n_pre, cos_sin = self._embed(batch)
        if cfg.family == "encdec":
            enc_hidden = self._encode(
                batch["enc_embeds"].to(_DTYPES[cfg.compute_dtype]))
            x, aux = self._backbone_encdec(x, cos_sin, enc_hidden)
        else:
            x, aux = self._backbone(x, cos_sin)
        x = x[:, n_pre:]
        x = cm.apply_norm(cfg, x, self.params["final_norm"])
        return cm.unembed(self.params["head"], x), aux

    def loss(self, batch):
        """(ce + router_aux_weight · aux, {"ce", "aux"}): the value only."""
        cfg = self.cfg
        logits, aux = self.forward(batch)
        ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab)
        return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # ========================================================== serving ===
    def init_cache(self, batch_size: int, max_seq: int):
        cfg, dev = self.cfg, self.device
        cdt = _DTYPES[cfg.compute_dtype]
        fam = cfg.family

        def zeros(*shape, dtype=cdt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        pos = zeros(dtype=torch.int64)
        if fam in ("dense", "vlm", "moe", "encdec"):
            shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv, cfg.hd)
            cache = {"k": zeros(*shape), "v": zeros(*shape), "pos": pos}
            if fam == "encdec":
                cross = (cfg.n_layers, batch_size,
                         max_seq // cfg.enc_frames_ratio, cfg.n_kv, cfg.hd)
                cache["ck"], cache["cv"] = zeros(*cross), zeros(*cross)
            return cache

        def per_layer(a):
            return a[None].expand(cfg.n_layers, *a.shape).clone()

        if fam == "ssm":
            st = rk.rwkv6_init_state(cfg, batch_size, dev)
            return {"layers": _map(per_layer, st), "pos": pos}
        if fam == "hybrid":
            st = mb.mamba2_init_state(cfg, batch_size, cdt, dev)
            kv = (cfg.n_layers // cfg.shared_attn_period, batch_size,
                  max_seq, cfg.n_kv, _shared_cfg(cfg).hd)
            return {"layers": _map(per_layer, st), "shared_k": zeros(*kv),
                    "shared_v": zeros(*kv), "pos": pos}
        raise ValueError(fam)

    @torch.no_grad()
    def prefill(self, batch, max_seq: int):
        """Process the full prompt, returning (last-position logits, cache)
        ready for :meth:`decode_step`; the cache holds ``max_seq``
        positions (a vlm's patches count)."""
        cfg = self.cfg
        fam = cfg.family
        x, n_pre, cos_sin = self._embed(batch)
        b, tt = x.shape[:2]
        if tt > max_seq:
            raise ValueError(f"a prompt of {tt} positions does not fit a "
                             f"cache of {max_seq}")
        cache = self.init_cache(b, max_seq)

        if fam in ("dense", "vlm", "moe", "encdec"):
            enc_hidden = None
            if fam == "encdec":
                enc_hidden = self._encode(
                    batch["enc_embeds"].to(_DTYPES[cfg.compute_dtype]))
                cks, cvs = [], []
            for li, p_l in enumerate(self._layers()):
                h = cm.apply_norm(cfg, x, p_l["ln1"])
                q, k, v = attn.qkv(p_l["attn"], cfg, h)
                q = cm.apply_rope(q, *cos_sin)
                k = cm.apply_rope(k, *cos_sin)
                cache["k"][li, :, :tt] = k
                cache["v"][li, :, :tt] = v
                o = attn.flash_attention(q, k, v, causal=True)
                o = o.reshape(b, tt, -1) @ p_l["attn"]["wo"].to(x.dtype)
                if cfg.parallel_block:
                    x = x + o + cm.mlp_apply(p_l["mlp"], h, cfg.act)
                    continue
                x = x + o
                if "cross" in p_l:
                    x, ck, cv = self._cross(p_l, x, enc_hidden)
                    cks.append(ck)
                    cvs.append(cv)
                h2 = cm.apply_norm(cfg, x, p_l["ln2"])
                if "moe" in p_l:
                    y, _ = moe_mod.moe_apply(p_l["moe"], cfg, h2)
                    x = x + y
                else:
                    x = x + cm.mlp_apply(p_l["mlp"], h2, cfg.act)
            if fam == "encdec":
                cache["ck"], cache["cv"] = torch.stack(cks), torch.stack(cvs)

        elif fam == "ssm":
            st0 = rk.rwkv6_init_state(cfg, b, x.device)
            sts = []
            for p_l in self._layers():
                x, st = rk.rwkv6_block(p_l, cfg, x, st0)
                sts.append(st)
            cache["layers"] = {k: torch.stack([s[k] for s in sts])
                               for k in st0}

        elif fam == "hybrid":
            x0 = x
            period = cfg.shared_attn_period
            layers = self._layers()
            scs = cm.rope_freqs(_shared_cfg(cfg).hd, cfg.rope_theta,
                                torch.arange(tt, device=x.device))
            sts = []
            for gi in range(cfg.n_layers // period):
                for p_l in layers[gi * period:(gi + 1) * period]:
                    y, st = mb.mamba2_apply(p_l, cfg, x, return_state=True)
                    x = x + y
                    sts.append(st)

                def attend(q, k, v, gi=gi):
                    cache["shared_k"][gi, :, :tt] = k
                    cache["shared_v"][gi, :, :tt] = v
                    return attn.flash_attention(q, k, v)
                x = self._shared_block(x, x0, scs, attend)
            cache["layers"] = {k: torch.stack([s[k] for s in sts])
                               for k in ("ssm", "conv")}
        else:
            raise ValueError(fam)

        cache["pos"] = torch.full((), tt, dtype=torch.int64, device=x.device)
        xl = cm.apply_norm(cfg, x[:, -1:], self.params["final_norm"])
        return cm.unembed(self.params["head"], xl), cache

    @torch.no_grad()
    def decode_step(self, token, cache, plain: bool = False):
        """token (B, 1) integer tensor -> (logits (B, 1, Vp), new cache).
        ``plain`` runs decode attention's plain form on the card."""
        cfg = self.cfg
        cdt = _DTYPES[cfg.compute_dtype]
        fam = cfg.family
        pos = cache["pos"]
        b = token.shape[0]
        x = F.embedding(token, self.params["embed"]["table"]).to(cdt)
        posb = pos.reshape(1)
        if cfg.mrope_sections:
            cos_sin = cm.mrope_freqs(cfg.hd, cfg.rope_theta,
                                     posb[None, None, :].expand(b, 3, 1),
                                     cfg.mrope_sections)
        else:
            cos_sin = cm.rope_freqs(cfg.hd, cfg.rope_theta, posb)

        if fam in ("dense", "vlm", "moe", "encdec"):
            for li, p_l in enumerate(self._layers()):
                h = cm.apply_norm(cfg, x, p_l["ln1"])
                o, _, _ = attn.decode_step(p_l["attn"], cfg, h,
                                           cache["k"][li], cache["v"][li],
                                           pos, cos_sin, plain)
                if cfg.parallel_block:
                    x = x + o + cm.mlp_apply(p_l["mlp"], h, cfg.act)
                    continue
                x = x + o
                if "cross" in p_l:
                    hq = cm.apply_norm(cfg, x, p_l["ln3"])
                    q, _, _ = attn.qkv(p_l["cross"], cfg, hq)
                    ck = cache["ck"][li]
                    oc = attn.decode_attention(q[:, 0], ck, cache["cv"][li],
                                               ck.shape[1], plain)
                    x = x + oc.reshape(b, 1, -1) \
                        @ p_l["cross"]["wo"].to(x.dtype)
                h2 = cm.apply_norm(cfg, x, p_l["ln2"])
                if "moe" in p_l:
                    y, _ = moe_mod.moe_apply(p_l["moe"], cfg, h2)
                    x = x + y
                else:
                    x = x + cm.mlp_apply(p_l["mlp"], h2, cfg.act)
            cache = dict(cache, pos=pos + 1)

        elif fam == "ssm":
            states = cache["layers"]
            sts = []
            for li, p_l in enumerate(self._layers()):
                x, st = rk.rwkv6_block(p_l, cfg, x,
                                       _map(lambda a: a[li], states))
                sts.append(st)
            cache = dict(cache, pos=pos + 1, layers={
                k: torch.stack([s[k] for s in sts]) for k in states})

        elif fam == "hybrid":
            x0 = x
            period = cfg.shared_attn_period
            states = cache["layers"]
            layers = self._layers()
            scs = cm.rope_freqs(_shared_cfg(cfg).hd, cfg.rope_theta, posb)
            sts = []
            for gi in range(cfg.n_layers // period):
                for li in range(gi * period, (gi + 1) * period):
                    y, st = mb.mamba2_decode(layers[li], cfg, x,
                                             _map(lambda a: a[li], states))
                    x = x + y
                    sts.append(st)

                def attend(q, k, v, gi=gi):
                    return attn.cache_attend(
                        q[:, 0], k, v, cache["shared_k"][gi],
                        cache["shared_v"][gi], pos, plain)
                x = self._shared_block(x, x0, scs, attend)
            cache = dict(cache, pos=pos + 1, layers={
                k: torch.stack([s[k] for s in sts]) for k in states})
        else:
            raise ValueError(fam)

        x = cm.apply_norm(cfg, x, self.params["final_norm"])
        return cm.unembed(self.params["head"], x), cache
