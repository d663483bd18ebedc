# Epoch-multiplexing job service (PyTorch port of ``repro.service``):
# co-schedule many independent task-parallel programs inside one shared
# TVM, paying the per-epoch launch + scalar readback (the paper's V_inf
# terms) once for the whole fleet — the §3 "work-together" principle
# extended across tenants.  A wave runs on the host-loop EpochMultiplexer
# (streaming completions, region reuse, preemption, masked/compacted/
# gather; its commit allocates each region's forks with the
# segmented_fork_scan CUDA kernel on the card) or resident on the device
# in the DeviceMultiplexer (K epochs a chunk; on the card the plain
# resident loop or one epoch_chunk launch a chunk), whose wave shapes the
# WaveTemplateCache keeps.
from .admission import AdmissionController, QuotaClass
from .api import JobFuture, JobService, merge_stats
from .jobs import (
    AdmissionError,
    Job,
    JobFailure,
    JobHandle,
    JobResult,
    JobStats,
    JobStatus,
    RegionCheckpoint,
    WaveTemplate,
    WaveTemplateCache,
    canonical_wave_order,
    wave_template_key,
)
from .multiplexer import (
    DeviceMultiplexer,
    EpochMultiplexer,
    TenantSlot,
    fuse_programs,
)

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "DeviceMultiplexer",
    "EpochMultiplexer",
    "Job",
    "JobFailure",
    "JobFuture",
    "JobHandle",
    "JobResult",
    "JobService",
    "JobStats",
    "JobStatus",
    "QuotaClass",
    "RegionCheckpoint",
    "TenantSlot",
    "WaveTemplate",
    "WaveTemplateCache",
    "canonical_wave_order",
    "fuse_programs",
    "merge_stats",
    "wave_template_key",
]
