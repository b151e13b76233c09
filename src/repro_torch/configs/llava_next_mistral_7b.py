"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import LLAVA as CONFIG

__all__ = ["CONFIG"]
