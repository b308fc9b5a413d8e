"""The CL system: MX serving precision, Algorithm 1 allocation policies,
the three CL kernels, the estimator and the CLSession engine behind the
CLSystemSpec front door."""
from repro_torch.core.allocation import (  # noqa: F401
    ALLOCATORS,
    AllocationDecision,
    AllocationPolicy,
    CLHyperParams,
    EkyaAllocator,
    EOMUAllocator,
    OnlineSpatiotemporalAllocator,
    PhaseFeedback,
    SpatialAllocator,
    SpatiotemporalAllocator,
    make_allocator,
)
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
    DaCapoEstimator,
    spatial_allocation,
)
from repro_torch.core.kernel import (  # noqa: F401
    InferenceKernel,
    LabelingKernel,
    RetrainKernel,
    ServingParamsCache,
)
from repro_torch.core.mx import DEFAULT_POLICY, PrecisionPolicy  # noqa: F401
from repro_torch.core.partition import SpatialPartition  # noqa: F401
from repro_torch.core.sample_buffer import SampleBuffer  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    CLResult,
    CLSession,
    CLSystemSpec,
    PhaseRecord,
    pretrain_model,
)
