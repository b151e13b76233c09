"""Model zoo: the dense decoder (qwen3 / llama) for serving."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, ShapeSpec, build_model
__all__ = ["Model", "ModelConfig", "ShapeSpec", "build_model"]
