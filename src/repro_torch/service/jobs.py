"""Job lifecycle for the epoch-multiplexing service (PyTorch port of
``repro/service/jobs.py``, host half).

A *job* is one tenant's task-parallel program — its own :class:`Program`,
seed task, heap initialization, and a slot *quota* (the size of the private
Task Vector region it is granted inside the shared TVM).  The service admits
jobs against a capacity budget, runs them co-scheduled with every other
admitted job (``multiplexer.py``), and reclaims the region the moment the
job's scheduler drains, so a queued job can take its place.

Admission control is static: everything checkable before the first epoch —
quota bounds, seed-task resolution, value-dtype uniformity across the fleet
— is checked at submit/fuse time and raises :class:`AdmissionError`; the
only runtime failure left is a job outgrowing its own quota, which fails
that job alone (its fork scatters are bounded by its region end, so a
runaway tenant cannot corrupt a neighbour).

The resident multiplexer's waves are keyed by shape (``wave_template_key``
over ``canonical_wave_order``), and a :class:`WaveTemplateCache` keeps one
:class:`WaveTemplate` per shape: the fused program, its slot layout and
the ``EpochLoop`` that owns the wave's resident bodies, so that a wave of
a shape seen before builds nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.program import InitialTask, Program


class JobStatus(enum.Enum):
    QUEUED = "queued"        # submitted, waiting for a region
    RUNNING = "running"      # co-scheduled in the shared TVM
    PREEMPTED = "preempted"  # checkpointed at a boundary, requeued
    DONE = "done"            # scheduler drained; result extracted
    FAILED = "failed"        # outgrew its quota (region overflow)


class AdmissionError(ValueError):
    """Job rejected before execution (quota / compatibility checks)."""


class JobFailure(RuntimeError):
    """Job failed at runtime (its own region overflowed)."""


@dataclasses.dataclass(frozen=True)
class Job:
    """One tenant program: what a solo ``HostEngine.run`` call would take,
    plus the TV-region quota the service reserves for it."""

    program: Program
    initial: InitialTask
    heap_init: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    quota: int = 1 << 10
    name: str = ""


@dataclasses.dataclass
class JobStats:
    """Per-job accounting in solo-comparable terms.

    ``epochs``/``tasks_executed``/``total_forks``/``peak_tv_slots`` match the
    solo run's ``RunStats`` fields exactly (the region is a bit-identical
    shifted copy of the solo TV).  ``shared_dispatches`` /
    ``shared_transfers`` count the fused launches this job rode along on.
    """

    epochs: int = 0
    tasks_executed: int = 0
    total_forks: int = 0
    peak_tv_slots: int = 0
    shared_dispatches: int = 0
    shared_transfers: int = 0

    def solo_dict(self) -> Dict[str, int]:
        """The four fields a solo ``RunStats`` must match bit for bit
        (the shared counts are service economics and legitimately differ
        between an uninterrupted run and a preempt/resume round trip)."""
        return {
            "epochs": self.epochs,
            "tasks_executed": self.tasks_executed,
            "total_forks": self.total_forks,
            "peak_tv_slots": self.peak_tv_slots,
        }


@dataclasses.dataclass
class JobResult:
    """What a solo run returns, extracted from the job's region.

    ``heap`` carries the job's own heap names (namespace stripped, no sink
    row); ``value`` is the region's TV-value block ``[quota, value_width]``
    in the job's own value width — bit-identical to a solo
    ``HostEngine.run`` with ``capacity=quota``.  Both are copies on the
    service's device.
    """

    heap: Dict[str, torch.Tensor]
    value: torch.Tensor
    stats: JobStats


@dataclasses.dataclass
class RegionCheckpoint:
    """A preempted job's region, lifted off the wave at an epoch boundary.

    Everything position-dependent is stored region-relative
    (``child_base``, range starts, the arena cursor) and task codes
    relative to the slot's task offset, so a restore may land the job in a
    different region of a different wave and still replay identically.
    Arrays are host numpy; the heap holds the tenant's own names.
    """

    structural_hash: Any    # whatever Program.structural_hash() returns
    quota: int
    # TV columns, sliced to [quota, ...]; child_base is region-relative.
    tv: Dict[str, np.ndarray]
    # tenant-local heap (namespace prefix and sink row stripped)
    heap: Dict[str, Any]
    arena_next_off: int        # arena cursor - region base
    sp: int                    # scheduler stack depth at capture
    jstack: np.ndarray         # i32[sp]   pending CENs (bottom -> top)
    rstack: np.ndarray         # i32[sp,2] (start-offset, count) per entry
    job_epochs: int = 0        # accumulator snapshot (solo-comparable)
    job_tasks: int = 0
    job_forks: int = 0
    job_peak: int = 0
    stats: Optional[JobStats] = None


@dataclasses.dataclass
class JobHandle:
    """Submission ticket: poll ``status``, read ``result`` when DONE.

    Lifecycle timestamps come from one injectable monotonic ``clock``
    (``time.monotonic`` by default) at the QUEUED -> RUNNING ->
    DONE/FAILED transitions: ``queue_wait`` and ``run_time``.
    ``priority`` / ``deadline`` / ``klass`` feed the admission layer
    (``deadline`` is absolute, in clock seconds).  ``checkpoint`` is set
    exactly while the job is PREEMPTED.
    """

    job_id: int
    job: Job
    status: JobStatus = JobStatus.QUEUED
    result: Optional[JobResult] = None
    error: Optional[Exception] = None
    submitted_at: Optional[float] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    clock: Callable[[], float] = dataclasses.field(
        default=time.monotonic, repr=False
    )
    priority: int = 0
    deadline: Optional[float] = None
    klass: str = "default"
    preemptions: int = 0
    checkpoint: Optional[RegionCheckpoint] = dataclasses.field(
        default=None, repr=False
    )

    def __post_init__(self) -> None:
        if self.submitted_at is None:
            self.submitted_at = self.clock()

    @property
    def done(self) -> bool:
        return self.status in (JobStatus.DONE, JobStatus.FAILED)

    def mark_running(self) -> None:
        """Stamp the QUEUED -> RUNNING transition (idempotent)."""
        self.status = JobStatus.RUNNING
        if self.started_at is None:
            self.started_at = self.clock()

    def mark_finished(self) -> None:
        """Stamp the terminal transition (status set by the caller)."""
        if self.finished_at is None:
            self.finished_at = self.clock()

    def mark_preempted(self, checkpoint: RegionCheckpoint) -> None:
        """RUNNING -> PREEMPTED: park the region image on the handle; the
        ``started_at`` stamp is kept."""
        self.status = JobStatus.PREEMPTED
        self.checkpoint = checkpoint
        self.preemptions += 1

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent QUEUED, once running (None before that)."""
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    @property
    def run_time(self) -> Optional[float]:
        """Seconds spent RUNNING, once finished (None before that)."""
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at


def validate_job(job: Job, capacity: int) -> None:
    """Static admission checks for one job against the service capacity."""
    if job.quota < 2:
        raise AdmissionError(
            f"job {job.name!r}: quota must be >= 2 (root slot + 1), "
            f"got {job.quota}"
        )
    if job.quota > capacity:
        raise AdmissionError(
            f"job {job.name!r}: quota {job.quota} exceeds service "
            f"capacity {capacity}"
        )
    try:
        job.program.task_id(job.initial.task)
    except KeyError:
        raise AdmissionError(
            f"job {job.name!r}: seed task {job.initial.task!r} not in "
            f"program {job.program.name!r}"
        ) from None


@dataclasses.dataclass
class WaveTemplate:
    """One wave *shape*, built: the fused program, its fuse-time slot
    layout, and the :class:`~repro_torch.core.engine.EpochLoop` that owns
    the resident bodies built for it (and, on the card, the device tables
    its ``epoch_chunk`` launches dispatch to).

    Two waves whose members are structurally equal (``structural_hash``)
    with the same quotas, capacity, stack depth, chunk size K, dispatch and
    chunk driver run the same loop, so the second wave runs on the first
    wave's template: only runtime state (TV, heap, stacks) is rebuilt.
    """

    key: Tuple
    program: Any   # fused Program
    slots: Any     # List[TenantSlot] (fuse-time layout)
    loop: Any      # EpochLoop (owns the resident bodies)


def canonical_wave_order(jobs: Sequence[Job]) -> Tuple[int, ...]:
    """Canonical member order of a wave: sort by (structural hash, quota).

    Two waves that are permutations of each other run the same template
    once their members are seated in the same order.  The sort is stable
    (ties keep submission order) and quotas ride the permutation, so the
    slot layout follows the members.  Results need no un-permuting: they
    attach to each job's own handle.
    """
    return tuple(sorted(
        range(len(jobs)),
        key=lambda i: (jobs[i].program.structural_hash(), jobs[i].quota),
    ))


def wave_template_key(jobs: Sequence[Job], capacity: int, stack_depth: int,
                      chunk, dispatch: str = "masked",
                      megakernel: bool = False) -> Tuple:
    """Cache key of one wave shape: member structure and quota layout in
    :func:`canonical_wave_order`, TV capacity, stack depth, the chunk size
    K (an int, ``None``, or ``"auto"``: adaptive-K waves share one entry,
    K being only the chunk's dynamic epoch bound), the resolved dispatch
    ("auto" is resolved by the service before keying, sticky per wave
    shape through :meth:`WaveTemplateCache.peek`) and the chunk driver
    (the plain loop or the ``epoch_chunk`` kernel)."""
    order = canonical_wave_order(jobs)
    return (
        tuple(jobs[i].program.structural_hash() for i in order),
        tuple(jobs[i].quota for i in order),
        int(capacity),
        int(stack_depth),
        chunk,
        str(dispatch),
        bool(megakernel),
    )


class WaveTemplateCache:
    """LRU cache of :class:`WaveTemplate` per wave shape.

    ``JobService(engine="device")`` consults it before fusing a wave: a hit
    runs the wave on the cached loop (``hits``/``misses`` make the reuse
    observable; ``trace_count`` sums the owned loops' build counters, so a
    test can assert that a hit built nothing).
    """

    def __init__(self, max_entries: int = 16):
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: "collections.OrderedDict[Tuple, WaveTemplate]" = (
            collections.OrderedDict()
        )
        # builds owned by templates since evicted: keeps trace_count
        # monotone, so an eviction can never hide a rebuild
        self._evicted_traces = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: Tuple) -> Optional[WaveTemplate]:
        t = self._entries.get(key)
        if t is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return t

    def peek(self, key: Tuple) -> Optional[WaveTemplate]:
        """Non-counting probe: dispatch="auto" checks which resolved-mode
        template already exists for a wave shape (the sticky-decision
        rule) without skewing the hit/miss counters or the LRU order."""
        return self._entries.get(key)

    def store(self, template: WaveTemplate) -> None:
        self._entries[template.key] = template
        self._entries.move_to_end(template.key)
        while len(self._entries) > self.max_entries:
            _, evicted = self._entries.popitem(last=False)
            self.evictions += 1
            self._evicted_traces += evicted.loop.trace_count

    @property
    def trace_count(self) -> int:
        """Resident bodies built across every template ever cached
        (evicted templates' builds stay counted: the total is monotone)."""
        return self._evicted_traces + sum(
            t.loop.trace_count for t in self._entries.values()
        )


def check_fleet_dtype(programs) -> torch.dtype:
    """All co-scheduled programs must share one TV value dtype.

    The shared value array has a single dtype; a tenant whose emits would
    be cast could not stay bit-identical to its solo run, so mixed-dtype
    fleets are rejected up front (they can still run in separate waves).
    """
    dtypes = {p.value_dtype for p in programs}
    if len(dtypes) > 1:
        raise AdmissionError(
            f"fleet mixes TV value dtypes {sorted(str(d) for d in dtypes)}; "
            "co-scheduled jobs must share one value dtype"
        )
    return dtypes.pop()
