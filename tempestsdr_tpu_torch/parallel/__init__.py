"""Scaling over processes and cards with torch.distributed, one process per
mesh position. Two axes, as in the JAX package:

  - channel: independent IQ channels (one per monitored emitter), data
    parallel, no collective (config 5): make_channel_step;
  - time: one wideband stream's block split into time shards, halos and
    the envelope by all_gather, the pixels by one psum (config 4,
    overlap-save): make_time_sharded_step; both together: make_grid_step.

mesh.make_mesh lays the ranks out; distributed.py brings the processes up
(init_distributed, make_global_mesh, local_channel_slice); launch.RankPool
starts a group of ranks on this host.
"""

from .mesh import make_mesh  # noqa: F401
from .channels import make_channel_step, stack_states  # noqa: F401
from .timeshard import make_time_sharded_step, make_grid_step  # noqa: F401
