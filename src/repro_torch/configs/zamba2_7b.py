"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import ZAMBA2 as CONFIG

__all__ = ["CONFIG"]
