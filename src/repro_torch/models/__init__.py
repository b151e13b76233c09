"""Model zoo for serving: the dense decoder (qwen3 / llama) and the zamba2
hybrid (Mamba2 + one shared attention block)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, ShapeSpec, build_model
__all__ = ["Model", "ModelConfig", "ShapeSpec", "build_model"]
