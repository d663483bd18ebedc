# The TVM abstract machine and the TREES epoch-synchronized runtime, ported
# to PyTorch: the host and resident engines (engine.py) over the scheduler
# (phase-1 policy: stacks, coalescing, dispatch sizing) over the TVM
# (phase-2/3 execution substrate, tvm.py), with the sequential oracle
# (interp.py) and the V1 / V_inf accounting (analysis.py) beside them.
from .engine import (
    ChunkSummary,
    DeviceEngine,
    EngineError,
    EpochLoop,
    HostEngine,
    MapLauncher,
    ResidentCarry,
)
from .interp import OracleStats, run_oracle
from .program import HeapVar, InitialTask, MapType, Program, TaskType
from .analysis import OverheadReport, compare
from .scheduler import (
    COMPACTED,
    GATHER,
    MASKED,
    DispatchPolicy,
    EpochScheduler,
    NullStats,
    RunStats,
    RunStatsCollector,
    StatsCollector,
    launch_bucket,
    resolve_policy,
)

__all__ = [
    "ChunkSummary",
    "DeviceEngine",
    "ResidentCarry",
    "EngineError",
    "EpochLoop",
    "HostEngine",
    "MapLauncher",
    "OracleStats",
    "run_oracle",
    "HeapVar",
    "InitialTask",
    "MapType",
    "Program",
    "TaskType",
    "OverheadReport",
    "compare",
    "COMPACTED",
    "GATHER",
    "MASKED",
    "DispatchPolicy",
    "EpochScheduler",
    "NullStats",
    "RunStats",
    "RunStatsCollector",
    "StatsCollector",
    "launch_bucket",
    "resolve_policy",
]
