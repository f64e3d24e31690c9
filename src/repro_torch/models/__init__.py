"""Model zoo of the port: ``DecoderLM`` serves the dense configs (qwen2,
h2o-danube, starcoder2, minitron), ``Mamba2LM`` the ssm family
(mamba2-370m) and ``Zamba2LM`` the hybrid family (zamba2-7b).  The other
families of the JAX package are not ported yet; ``build_model`` names the
ROADMAP item that ports each."""

from .config import ArchConfig
from .mamba2 import Mamba2LM
from .transformer import DecoderLM
from .zamba2 import Zamba2LM

_NOT_PORTED = {
    "moe": "MoE layers are not ported yet (ROADMAP A14)",
    "audio": "Whisper is not ported yet (ROADMAP A16)",
    "vlm": "InternVL is not ported yet (ROADMAP A16)",
}


def build_model(cfg: ArchConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.family])
    return {"dense": DecoderLM, "ssm": Mamba2LM,
            "hybrid": Zamba2LM}[cfg.family](cfg)


__all__ = ["ArchConfig", "DecoderLM", "Mamba2LM", "Zamba2LM", "build_model"]
