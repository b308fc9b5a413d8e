"""Runtime support for the fleet and manager tiers: fault injection,
heartbeats and the resilient loop (``fault``), and landing state on a
device or a mesh (``elastic``)."""
from repro_torch.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    rehome_tree,
    reshard_tree,
)
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    Heartbeat,
    InjectedFailure,
    StragglerDetector,
    resilient_loop,
)
