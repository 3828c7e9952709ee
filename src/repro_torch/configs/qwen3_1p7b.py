"""qwen3-1.7b [dense]: 28L, d_model=2048, 16H (GQA kv=8), d_ff=6144,
vocab=151936, qk-norm, head_dim=128 [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144,
        vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    )


def smoke_config():
    return ArchConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, qk_norm=True,
    )
