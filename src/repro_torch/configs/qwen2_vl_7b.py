"""qwen2-vl-7b [vlm]: 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064, M-RoPE (sections 16/24/24 over half-dim 64), dynamic
resolution [arXiv:2409.12191; hf].  Vision frontend is a STUB: the batch's
``patch_embeds`` are precomputed patch embeddings (256 tokens prepended)."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944,
        vocab=152064, head_dim=128, bias=True,
        mrope_sections=(16, 24, 24), n_patches=256, rope_theta=1e6,
    )


def smoke_config():
    return ArchConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, bias=True,
        mrope_sections=(4, 2, 2), n_patches=16,
    )
