"""rwkv6-7b "Finch" [ssm]: 32L, d_model=4096, attention-free with
data-dependent decay; channel-mix hidden 14336 = 3.5*d, vocab=65536
[arXiv:2404.05892; hf]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336,
        vocab=65536, ssm_head_dim=64,
    )


def smoke_config():
    return ArchConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=224,
        vocab=512, ssm_head_dim=16,
    )
