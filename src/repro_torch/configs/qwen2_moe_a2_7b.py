"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import QWEN2_MOE as CONFIG

__all__ = ["CONFIG"]
