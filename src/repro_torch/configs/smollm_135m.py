"""smollm-135m [dense]: 30L, d_model=576, 9H (GQA kv=3), d_ff=1536,
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
        vocab=49152,
    )


def smoke_config():
    return ArchConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv=1, d_ff=128, vocab=512,
    )
