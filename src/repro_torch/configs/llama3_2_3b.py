"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import LLAMA32 as CONFIG

__all__ = ["CONFIG"]
