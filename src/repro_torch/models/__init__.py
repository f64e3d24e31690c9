"""Model zoo of the port, every family of the JAX package: ``DecoderLM``
(the dense configs and the MoE granite configs), ``Mamba2LM`` (ssm),
``Zamba2LM`` (hybrid), ``WhisperModel`` (audio) and ``InternVLModel``
(vlm); and one of its own, ``GraniteHybridLM`` (hybrid_moe,
granite-4.0-h)."""

from .config import ArchConfig, HybridMoEConfig
from .granite_hybrid import GraniteHybridLM
from .internvl import InternVLModel
from .mamba2 import Mamba2LM
from .transformer import DecoderLM
from .whisper import WhisperModel
from .zamba2 import Zamba2LM


def build_model(cfg: ArchConfig):
    return {
        "dense": DecoderLM,
        "moe": DecoderLM,
        "ssm": Mamba2LM,
        "hybrid": Zamba2LM,
        "hybrid_moe": GraniteHybridLM,
        "audio": WhisperModel,
        "vlm": InternVLModel,
    }[cfg.family](cfg)


__all__ = ["ArchConfig", "DecoderLM", "GraniteHybridLM", "HybridMoEConfig",
           "InternVLModel", "Mamba2LM", "WhisperModel", "Zamba2LM",
           "build_model"]
