"""Architecture registry of the port.  ``get_config(name)`` resolves the
archs this slice serves; every other arch of the reference registry raises
``NotImplementedError`` naming the ROADMAP slice that brings it."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    H100, HWSpec, LayerSpec, ModelConfig, pad_to)
from repro_torch.configs.smollm_135m import CONFIG as _SMOLLM_135M

_PORTED: dict[str, ModelConfig] = {"smollm-135m": _SMOLLM_135M}

# arch id -> the ROADMAP queue-1 item that ports it
_LATER: dict[str, str] = {
    "qwen2-1.5b": "item 3 (model-family breadth: qkv bias)",
    "gemma2-27b": "item 3 (model-family breadth: window + softcap)",
    "minicpm3-4b": "item 3 (model-family breadth: MLA)",
    "qwen2-moe-a2.7b": "item 3 (model-family breadth: MoE)",
    "llama4-maverick-400b-a17b": "item 3 (model-family breadth: MoE)",
    "qwen2-vl-7b": "item 3 (model-family breadth: M-RoPE)",
    "jamba-1.5-large-398b": "item 3 (model-family breadth: Mamba)",
    "rwkv6-3b": "item 3 (model-family breadth: RWKV-6 with kernel K4)",
    "whisper-medium": "item 3 (model-family breadth: encoder-decoder)",
    "chatglm2-6b": "item 3 (model-family breadth)",
}


def get_config(name: str) -> ModelConfig:
    if name in _PORTED:
        return _PORTED[name]
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP queue 1 {_LATER[name]}")
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(_PORTED) + sorted(_LATER)}")

