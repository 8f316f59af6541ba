"""Architecture registry of the port.  ``get_config(name)`` resolves every
arch of the reference registry; an unknown name raises ``KeyError``.
``list_archs`` names the reference's assigned archs in its order, and with
``include_extra`` the paper's own chatglm2-6b too."""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    H100, SHAPES, HWSpec, LayerSpec, MambaConfig, MLAConfig, ModelConfig,
    MoEConfig, RWKVConfig, ShapeConfig, cell_is_runnable, group_period, pad_to)
from repro_torch.configs.chatglm2_6b import CONFIG as _CHATGLM2_6B
from repro_torch.configs.gemma2_27b import CONFIG as _GEMMA2_27B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _JAMBA_1_5_LARGE
from repro_torch.configs.llama4_maverick_400b_a17b import \
    CONFIG as _LLAMA4_MAVERICK
from repro_torch.configs.minicpm3_4b import CONFIG as _MINICPM3_4B
from repro_torch.configs.qwen2_1_5b import CONFIG as _QWEN2_1_5B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _QWEN2_MOE_A2_7B
from repro_torch.configs.qwen2_vl_7b import CONFIG as _QWEN2_VL_7B
from repro_torch.configs.rwkv6_3b import CONFIG as _RWKV6_3B
from repro_torch.configs.smollm_135m import CONFIG as _SMOLLM_135M
from repro_torch.configs.whisper_medium import CONFIG as _WHISPER_MEDIUM

_PORTED: dict[str, ModelConfig] = {"smollm-135m": _SMOLLM_135M,
                                   "rwkv6-3b": _RWKV6_3B,
                                   "chatglm2-6b": _CHATGLM2_6B,
                                   "qwen2-1.5b": _QWEN2_1_5B,
                                   "gemma2-27b": _GEMMA2_27B,
                                   "minicpm3-4b": _MINICPM3_4B,
                                   "qwen2-moe-a2.7b": _QWEN2_MOE_A2_7B,
                                   "qwen2-vl-7b": _QWEN2_VL_7B,
                                   "whisper-medium": _WHISPER_MEDIUM,
                                   "llama4-maverick-400b-a17b":
                                       _LLAMA4_MAVERICK,
                                   "jamba-1.5-large-398b": _JAMBA_1_5_LARGE}


def get_config(name: str) -> ModelConfig:
    if name in _PORTED:
        return _PORTED[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_PORTED)}")



# the reference's registry order (``repro/configs/__init__.py:14``);
# chatglm2-6b, the paper's own evaluation model, is not an assigned cell
_ORDER = ("llama4-maverick-400b-a17b", "qwen2-moe-a2.7b", "whisper-medium",
          "qwen2-1.5b", "smollm-135m", "gemma2-27b", "minicpm3-4b",
          "jamba-1.5-large-398b", "qwen2-vl-7b", "rwkv6-3b", "chatglm2-6b")


def list_archs(include_extra: bool = False) -> list[str]:
    return list(_ORDER) if include_extra else list(_ORDER[:-1])
