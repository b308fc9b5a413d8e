"""Runtime support for the fleet tier: landing restored lane state on a
device (``elastic.rehome_tree``). The rest of the JAX package's
``runtime`` (fault injection, heartbeats, resharding onto a mesh) comes
with the sharded manager tier (ROADMAP Queue 1, item 9a)."""
from repro_torch.runtime.elastic import rehome_tree  # noqa: F401
