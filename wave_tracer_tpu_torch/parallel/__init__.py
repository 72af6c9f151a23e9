"""Rendering across devices: one torch.distributed rank per device
(`launch`), lanes split over the ranks and the films merged by all-reduce
(`dist`)."""

from wave_tracer_tpu_torch.parallel.dist import (  # noqa: F401
    render_distributed, sharded_render_step)
