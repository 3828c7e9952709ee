"""deepseek-moe-16b [moe]: 28L, d_model=2048, 16H (kv=16), expert
d_ff=1408, vocab=102400, 64 fine-grained routed experts top-6 + 2 shared
(always-on) experts [arXiv:2401.06066; hf].  (The published model's first
layer is dense; we use the uniform-MoE stack and note the simplification.)"""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
        vocab=102400, n_experts=64, top_k=6, n_shared_experts=2,
        capacity_factor=1.25,
    )


def smoke_config():
    return ArchConfig(
        name="deepseek-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=32,
        vocab=512, n_experts=8, top_k=3, n_shared_experts=2,
        capacity_factor=1.5,
    )
