"""--arch config module (exact published spec; see registry.py)."""
from repro_torch.configs.registry import H2O_DANUBE as CONFIG

__all__ = ["CONFIG"]
