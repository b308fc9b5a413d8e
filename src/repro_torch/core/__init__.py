"""The CL system: MX serving precision, Algorithm 1 allocation policies,
the three CL kernels, mesh spatial partitioning, the estimators, the
CLSession engine behind the CLSystemSpec front door, and the trace spine
with its replayer."""
from repro_torch.core.allocation import (  # noqa: F401
    ALLOCATORS,
    AllocationDecision,
    AllocationPolicy,
    CLHyperParams,
    EkyaAllocator,
    EOMUAllocator,
    OnlineSpatiotemporalAllocator,
    PhaseFeedback,
    ReplayAllocator,
    SpatialAllocator,
    SpatiotemporalAllocator,
    make_allocator,
)
# ``SCHEDULERS`` is the legacy alias for the allocator registry; imported
# from allocation (not the deprecated core.scheduler shim) so importing
# repro_torch.core stays warning-free.
from repro_torch.core.allocation import ALLOCATORS as SCHEDULERS  # noqa: F401
from repro_torch.core.cl_system import ContinuousLearningSystem  # noqa: F401
from repro_torch.core.decision import (  # noqa: F401
    Decision,
    SpatialPlan,
    TemporalPlan,
    as_decision,
)
from repro_torch.core.dispatch import (  # noqa: F401
    DISPATCH_MODES,
    DeviceProgram,
    KernelDispatcher,
    PhasePlan,
    ProgramHandle,
)
from repro_torch.core.estimator import (  # noqa: F401
    CalibratedEstimator,
    DaCapoEstimator,
    PlacementCostModel,
    TPUEstimator,
    spatial_allocation,
)
from repro_torch.core.kernel import (  # noqa: F401
    InferenceKernel,
    Kernel,
    LabelingKernel,
    RetrainKernel,
    ServingParamsCache,
)
from repro_torch.core.mx import (  # noqa: F401
    DEFAULT_POLICY,
    PrecisionPolicy,
    mx_dense,
)
from repro_torch.core.partition import (  # noqa: F401
    RowMesh,
    SpatialPartition,
    partition_mesh,
)
from repro_torch.core.replay import (  # noqa: F401
    Calibration,
    ReplayNode,
    TraceReplayer,
)
from repro_torch.core.sample_buffer import SampleBuffer  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    CLResult,
    CLSession,
    CLSystemSpec,
    PhaseRecord,
    pretrain_model,
)
from repro_torch.core.trace import (  # noqa: F401
    PhaseTrace,
    SessionTrace,
    TraceEvent,
    TraceRecorder,
)
