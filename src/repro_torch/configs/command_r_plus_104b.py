"""command-r-plus-104b [dense]: 64L, d_model=12288, 96H (GQA kv=8),
d_ff=33792, vocab=256000, no-bias, parallel attn+FFN blocks, LayerNorm
[hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv=8, d_ff=33792,
        vocab=256000, bias=False, parallel_block=True, norm="layer",
        rope_theta=75e6,
    )


def smoke_config():
    return ArchConfig(
        name="command-r-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, parallel_block=True, norm="layer",
    )
