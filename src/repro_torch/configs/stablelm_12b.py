"""stablelm-12b [dense]: 40L, d_model=5120, 32H (GQA kv=8), d_ff=13824,
vocab=100352, per-head qk-norm, LayerNorm [hf:stabilityai/stablelm-2-12b; hf]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=13824,
        vocab=100352, norm="layer", qk_norm=True,
    )


def smoke_config():
    return ArchConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, norm="layer", qk_norm=True,
    )
