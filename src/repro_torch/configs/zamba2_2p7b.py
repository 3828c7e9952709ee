"""zamba2-2.7b [hybrid]: 54 Mamba2 layers, d_model=2560, ssm_state=64,
plus a weight-SHARED full transformer block (32H MHA over concat[h, embed],
d_ff=10240) applied every 6 layers [arXiv:2411.15242; hf]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
        vocab=32000, ssm_state=64, ssm_head_dim=64, shared_attn_period=6,
    )


def smoke_config():
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=512, ssm_state=16, ssm_head_dim=16, shared_attn_period=2,
    )
