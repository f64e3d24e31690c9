"""Model zoo of the port, every family of the JAX package: ``DecoderLM``
(the dense configs and the MoE granite configs), ``Mamba2LM`` (ssm),
``Zamba2LM`` (hybrid), ``WhisperModel`` (audio) and ``InternVLModel``
(vlm)."""

from .config import ArchConfig
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
        "audio": WhisperModel,
        "vlm": InternVLModel,
    }[cfg.family](cfg)


__all__ = ["ArchConfig", "DecoderLM", "InternVLModel", "Mamba2LM",
           "WhisperModel", "Zamba2LM", "build_model"]
