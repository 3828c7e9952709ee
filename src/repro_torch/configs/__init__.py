"""Architecture registry (the port's copy of ``repro/configs``):
``get_config(arch_id)`` resolves an ``--arch`` id.

Each LM module exposes ``config()`` (the published hyperparameters) and
``smoke_config()`` (a reduced same-family config for CPU tests); the three
CG problems (``laplace2d``, ``icesheet3d``, ``icesheet3d-stencil``) are the
paper's own benchmark problems.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "seamless-m4t-large-v2",
    "qwen3-1.7b",
    "command-r-plus-104b",
    "smollm-135m",
    "stablelm-12b",
    "qwen2-vl-7b",
    "arctic-480b",
    "deepseek-moe-16b",
    "zamba2-2.7b",
    "rwkv6-7b",
    # the paper's own "architectures" — CG benchmark problems
    "laplace2d",
    "icesheet3d",
    "icesheet3d-stencil",
]

_MOD = {i: i.replace("-", "_").replace(".", "p") for i in ARCH_IDS}


def get_config(arch_id: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.smoke_config() if smoke else mod.config()


CG_ARCH_IDS = ("laplace2d", "icesheet3d", "icesheet3d-stencil")


def lm_arch_ids():
    return [i for i in ARCH_IDS if i not in CG_ARCH_IDS]
