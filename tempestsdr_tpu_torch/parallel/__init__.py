"""Channel data parallelism: independent IQ channels (one per monitored
emitter), each with its own state on a leading channel axis
(BASELINE.json config 5). On one card the channel steps of
stream.pipeline run them; the mesh-sharded step waits for a multi-process
mesh."""

from .channels import stack_states  # noqa: F401
