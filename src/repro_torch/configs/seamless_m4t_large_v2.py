"""seamless-m4t-large-v2 [audio]: enc-dec multimodal, 24L enc + 24L dec,
d_model=1024, 16H (kv=16), d_ff=8192, vocab=256206 [arXiv:2308.11596; hf].
The speech frontend is a STUB: the batch's ``enc_embeds`` are precomputed
frame embeddings (seq//4 frames)."""
from repro_torch.models.config import ArchConfig


def config():
    return ArchConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, n_enc_layers=24,
        d_model=1024, n_heads=16, n_kv=16, d_ff=8192, vocab=256206,
        act="relu", norm="layer", bias=True, enc_frames_ratio=4,
    )


def smoke_config():
    return ArchConfig(
        name="seamless-smoke", family="encdec",
        n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512,
        act="relu", norm="layer", bias=True, enc_frames_ratio=4,
    )
