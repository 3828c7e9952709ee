"""Batched LM serving on the PyTorch port: prefill a batch of random
prompts, then decode greedily step by step through the KV cache or the
recurrent state, each step's token fed back as a device tensor (no host
read inside the loop).  On the card every decode step's attention runs
the hand-written split-KV kernel.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch rwkv6-7b] \\
        [--batch 4] [--prompt-len 32] [--tokens 32] [--device cpu] [--full]

The smoke config by default (as ``examples/serve_lm.py``); ``--full`` the
published one.  Weights are random, from a seeded generator.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, lm_arch_ids
from repro_torch.device import resolve_device
from repro_torch.models import LM


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-1.7b",
                    choices=lm_arch_ids())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    model = LM(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)

    b, t = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                     device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(b, cfg.n_patches, cfg.d_model,
                                            generator=gen, device=dev)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(
            b, t // cfg.enc_frames_ratio, cfg.d_model, generator=gen,
            device=dev)
    max_seq = t + args.tokens + (cfg.n_patches if cfg.family == "vlm" else 0)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_seq)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    _sync(dev)
    t1 = time.perf_counter()
    print(f"[{cfg.name}] prefill {b}x{t} on {dev}: {(t1 - t0) * 1e3:.1f} ms "
          "(first call)")

    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        logits, cache = model.decode_step(tok, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        outs.append(tok)
    _sync(dev)
    t1 = time.perf_counter()
    gen_ids = torch.cat(outs, dim=1)
    print(f"decoded {args.tokens} tokens/seq: "
          f"{(t1 - t0) / max(args.tokens - 1, 1) * 1e3:.2f} ms/step on {dev}")
    print("sample token ids:", gen_ids[0, :16].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()
