"""Architecture configuration of the LM side path (the port's copy of
``repro/models/config.py``): one dataclass covers all ten LM archs.

Families:
  dense   — decoder-only GQA transformer (qwen3, command-r+, smollm, stablelm)
  vlm     — dense decoder + M-RoPE + stub patch-embedding frontend (qwen2-vl)
  moe     — decoder with MoE FFN (arctic: +dense residual; deepseek: shared
            experts + fine-grained routed)
  hybrid  — Mamba2 backbone with a weight-SHARED attention block applied
            every ``shared_attn_period`` layers (zamba2)
  ssm     — RWKV6 "Finch" (attention-free, data-dependent decay)
  encdec  — encoder-decoder with cross-attention + stub audio frontend
            (seamless-m4t; 24 encoder + 24 decoder layers per the published
            model card)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | vlm | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    # encoder-decoder
    n_enc_layers: int = 0          # encdec only
    enc_frames_ratio: int = 4      # stub audio frames = seq // ratio

    # attention details
    head_dim: Optional[int] = None # default d_model // n_heads
    qk_norm: bool = False          # qwen3
    bias: bool = False
    parallel_block: bool = False   # command-r parallel attn+FFN
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()     # qwen2-vl M-RoPE (t,h,w) half-dim split

    # FFN
    act: str = "swiglu"            # swiglu | gelu | relu
    norm: str = "rms"              # rms | layer

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0      # deepseek shared experts
    dense_residual: bool = False   # arctic dense FFN residual
    dense_ff: int = 0              # d_ff of the dense residual / first dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0             # mamba2 d_state
    ssm_head_dim: int = 64
    shared_attn_period: int = 6    # zamba2: attn block every N mamba layers

    # vlm stub
    n_patches: int = 256           # stub image tokens prepended

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # sizing used by roofline bookkeeping
    max_seq: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ --
    def param_count(self) -> float:
        """Analytic parameter count (embeddings included once a table; the
        JAX package's formula, term for term)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv * hd) \
            + (self.n_heads * hd) * d
        if self.act == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        emb = self.vocab_padded * d

        if self.family == "ssm":          # rwkv6
            dk = self.d_model             # inner == d_model
            tm = 4 * d * dk + 2 * 32 * d + d * dk   # r,k,v,g (+w lora) + out
            cm = 2 * d * int(3.5 * d)
            return self.n_layers * (tm + cm) + 2 * emb

        if self.family == "hybrid":       # zamba2
            d_in = 2 * d
            mamba = d * (2 * d_in + 2 * self.n_heads * 0) \
                + d * d_in + d_in * d \
                + d_in * (2 * self.ssm_state) + d_in
            shared = 2 * d * (self.n_heads * hd) * 2 + 3 * (2 * d) * self.d_ff
            return self.n_layers * (mamba + d * 2 * self.ssm_state * 2) \
                + shared + 2 * emb

        per_layer = attn + mlp
        if self.family == "moe":
            moe_mlp = self.n_experts * 3 * d * self.d_ff
            shared = self.n_shared_experts * 3 * d * self.d_ff
            dense = 3 * d * (self.dense_ff or self.d_ff) \
                if self.dense_residual else 0
            per_layer = attn + moe_mlp + shared + dense + d * self.n_experts
        n = self.n_layers * per_layer + 2 * emb
        if self.family == "encdec":
            n += self.n_enc_layers * (attn + mlp)
            n += self.n_layers * attn               # cross-attention blocks
        return float(n)

    def active_param_count(self) -> float:
        """Active params per token (MoE: top-k + shared + dense residual)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * (self.n_heads * self.hd) + d * (2 * self.n_kv * self.hd) \
            + (self.n_heads * self.hd) * d
        act_mlp = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        dense = 3 * d * (self.dense_ff or self.d_ff) \
            if self.dense_residual else 0
        return float(
            self.n_layers * (attn + act_mlp + dense + d * self.n_experts)
            + 2 * self.vocab_padded * d
        )
