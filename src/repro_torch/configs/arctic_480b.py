"""arctic-480b [moe]: 35L, d_model=7168, 56H (GQA kv=8), expert d_ff=4864,
vocab=32000, MoE 128 experts top-2 PLUS a dense-FFN residual branch
(dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base; hf].
dense_ff=8192 approximates the published ~10B dense component."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
        vocab=32000, n_experts=128, top_k=2,
        dense_residual=True, dense_ff=8192, capacity_factor=1.25,
    )


def smoke_config():
    # generous capacity so CPU smoke tests exercise drop-free routing
    # (the full config keeps the production 1.25)
    return ArchConfig(
        name="arctic-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=64,
        vocab=512, n_experts=8, top_k=2,
        dense_residual=True, dense_ff=96, capacity_factor=6.0,
    )
