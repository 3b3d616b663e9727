"""Model presets: the spectral CNNs (``vgg16_spectral``,
``resnet18_spectral``) and the architecture registry of the LM pillar
(counterpart of ``repro.configs``): one module per assigned
architecture.

``get_config(arch)`` returns the full published config;
``get_smoke_config(arch)`` a reduced same-family config for CPU tests.
``SHAPES`` are the assigned input-shape cells.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "zamba2-7b",
    "whisper-medium",
    "qwen3-8b",
    "yi-6b",
    "smollm-135m",
    "h2o-danube-1.8b",
    "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b",
    "chameleon-34b",
    "xlstm-350m",
)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs bounded-state decode: run only for SSM/hybrid/SWA archs,
# skip pure full-attention archs.
LONG_CONTEXT_ARCHS = {"zamba2-7b", "h2o-danube-1.8b", "xlstm-350m"}


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    if arch == "vgg16-spectral":
        raise ValueError("use repro_torch.models.cnn.SpectralCNNConfig")
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, with applicability filtering."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skipped = (shape.name == "long_500k"
                       and arch not in LONG_CONTEXT_ARCHS)
            if include_skipped or not skipped:
                out.append((arch, shape.name, skipped))
    return out
