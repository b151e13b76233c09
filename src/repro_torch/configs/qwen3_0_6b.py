"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import QWEN3 as CONFIG

__all__ = ["CONFIG"]
