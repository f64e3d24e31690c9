"""Model zoo of the port: the dense decoder LM (``DecoderLM``) serves the
dense configs (qwen2, h2o-danube, starcoder2, minitron).  The other families
of the JAX package are not ported yet; ``build_model`` names the ROADMAP item
that ports each."""

from .config import ArchConfig
from .transformer import DecoderLM

_NOT_PORTED = {
    "moe": "MoE layers are not ported yet (ROADMAP A14)",
    "ssm": "Mamba2 is not ported yet (ROADMAP A15)",
    "hybrid": "Zamba2 is not ported yet (ROADMAP A15)",
    "audio": "Whisper is not ported yet (ROADMAP A16)",
    "vlm": "InternVL is not ported yet (ROADMAP A16)",
}


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.family])
    return {"dense": DecoderLM}[cfg.family](cfg)


__all__ = ["ArchConfig", "DecoderLM", "build_model"]
