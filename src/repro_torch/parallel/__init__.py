"""Distribution substrate: gradient compression and accumulation.  The
sharding rules and the pipeline schedule come with the port's distribution
slice."""
from repro_torch.parallel.collectives import (
    accumulate_grads,
    compress_with_feedback,
    init_error_buf,
)
__all__ = ["accumulate_grads", "compress_with_feedback", "init_error_buf"]
