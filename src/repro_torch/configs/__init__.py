"""Config registry: assigned architectures + shapes. See registry.py."""
from repro_torch.configs.registry import ARCHS, ASSIGNED, SHAPES, SMOKE_SHAPES, cells, get
__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "SMOKE_SHAPES", "cells", "get"]
