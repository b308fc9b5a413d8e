"""The data plane: drifting frame streams, the speculative pipeline and
token streams (numpy-only copies of the JAX package's data/ modules)."""
from repro_torch.data.pipeline import (  # noqa: F401
    FramePipeline,
    SpeculationStats,
)
from repro_torch.data.stream import (  # noqa: F401
    DriftStream,
    PrefetchingWindowIterator,
    SCENARIOS,
    Segment,
    scenario,
)
from repro_torch.data.tokens import TokenPipeline  # noqa: F401
