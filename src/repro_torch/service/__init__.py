# Epoch-multiplexing job service, host half (PyTorch port of
# ``repro.service``): co-schedule many independent task-parallel programs
# inside one shared TVM, paying the per-epoch launch + scalar readback (the
# paper's V_inf terms) once for the whole fleet — the §3 "work-together"
# principle extended across tenants.  Each wave runs on the host-loop
# EpochMultiplexer (streaming completions, region reuse, preemption,
# masked/compacted/gather); its commit allocates each region's forks with
# the segmented_fork_scan CUDA kernel on the card.  The resident
# DeviceMultiplexer and the wave templates are the device half (ROADMAP
# item 7b).
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
)
from .multiplexer import EpochMultiplexer, TenantSlot, fuse_programs

__all__ = [
    "AdmissionController",
    "AdmissionError",
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
    "fuse_programs",
    "merge_stats",
]
