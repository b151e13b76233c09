"""Model zoo for serving: every family of the registry -- dense (qwen3 /
llama), MoE (qwen2-moe / granite-moe), VLM (llava), the zamba2 hybrid
(Mamba2 + one shared attention block), the seamless encoder-decoder and
xLSTM."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, ShapeSpec, build_model
__all__ = ["Model", "ModelConfig", "ShapeSpec", "build_model"]
