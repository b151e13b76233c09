"""Distribution substrate: gradient compression and accumulation
(``collectives``), the sharding rules on DeviceMesh and DTensor
(``sharding``) and the GPipe schedule (``pipeline``)."""
from repro_torch.parallel.collectives import (
    accumulate_grads,
    compress_with_feedback,
    init_error_buf,
)
__all__ = ["accumulate_grads", "compress_with_feedback", "init_error_buf"]
