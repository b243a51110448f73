"""Architecture registry of the port (``repro/models/registry.py``):
config lookup and the input-shape registry.  granite-3-2b (dense) and
deepseek-v2-lite-16b (MLA + MoE) are ported; the others raise and name
the ROADMAP item that brings them."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.common import ArchConfig

ARCH_IDS = (
    "granite-3-2b",
    "hubert-xlarge",
    "paligemma-3b",
    "dbrx-132b",
    "yi-34b",
    "hymba-1.5b",
    "xlstm-350m",
    "qwen1.5-110b",
    "llama3-405b",
    "deepseek-v2-lite-16b",
)
PORTED = ("granite-3-2b", "deepseek-v2-lite-16b")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP queue 1, slice 3 "
            f"item 7: the rest of models/ and configs/); ported: {PORTED}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return get_config(arch_id).smoke()
