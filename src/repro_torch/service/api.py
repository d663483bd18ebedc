"""Execution surface of the serving front door (PyTorch port of
``repro/service/api.py``, host engine).

:class:`JobService` is the multi-tenant front door: ``submit`` enqueues a
program with a TV-region quota — optionally under a
:class:`~repro_torch.service.admission.QuotaClass` with a priority and a
deadline — ``poll`` reports its lifecycle state, ``result`` drives the
fleet until that job finishes, and ``completions`` streams handles the
moment each job's scheduler drains.  ``submit_async`` /
:meth:`JobService.stream_results` are the non-blocking face of the same
queue: a :class:`JobFuture` awaits one job while the service keeps
pumping cooperatively.

The service runs jobs in *waves*: a wave is one fused fleet (up to
``max_jobs`` jobs whose quotas fit the capacity budget and whose value
dtypes agree), on the host loop
(:class:`~repro_torch.service.multiplexer.EpochMultiplexer`,
``engine="host"``) or resident on the device
(:class:`~repro_torch.service.multiplexer.DeviceMultiplexer`,
``engine="device"``: K epochs a chunk, or the whole wave with
``chunk=None``; ``megakernel=True`` runs each chunk on the card as one
``epoch_chunk`` launch).  A device wave's members are seated in
:func:`~repro_torch.service.jobs.canonical_wave_order` and its shape is
looked up in a :class:`~repro_torch.service.jobs.WaveTemplateCache`, so a
wave of a shape seen before builds nothing (``trace_count``).  A host
wave of the previous host wave's layout runs on that wave's epoch loop,
CUDA graphs and device buffers, so that on the card its step keys are
already captured.  While a wave is in flight, queued jobs whose program
matches a freed region are admitted mid-flight; everything else waits for
the next wave.  At each epoch boundary the admission layer may preempt a
running job into a :class:`~repro_torch.service.jobs.RegionCheckpoint`
for a strictly higher-priority waiter; the resumed run stays
bit-identical to an uninterrupted one.

Not ported yet: the sharded fleet (``engine="sharded"``, ROADMAP item
9), ``dispatch="auto"``, ``chunk="auto"`` and the ``metrics``/``tracer``
observability hooks (item 8).  Asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import asyncio
import itertools
import time
from typing import (
    Any, AsyncIterator, Callable, Iterator, List, Mapping, Optional,
)

from ..core.engine import resolve_device
from ..core.program import InitialTask, Program
from ..core.scheduler import RunStats, resolve_policy
from .admission import AdmissionController, QuotaClass
from .jobs import (
    AdmissionError,
    Job,
    JobHandle,
    JobResult,
    JobStatus,
    WaveTemplate,
    WaveTemplateCache,
    canonical_wave_order,
    validate_job,
    wave_template_key,
)
from .multiplexer import (
    DeviceMultiplexer,
    EpochMultiplexer,
    check_resident_options,
)


def merge_stats(into: RunStats, s: RunStats) -> RunStats:
    """Accumulate one wave's fleet stats into a running total
    (:meth:`~repro_torch.core.scheduler.RunStats.merge`)."""
    return into.merge(s)


class JobFuture:
    """Awaitable face of one submitted job.

    Awaiting it drives the service cooperatively — one
    :meth:`JobService._pump` per event-loop turn — until this job reaches
    a terminal state.  Futures awaited together share the service's
    single-threaded pump.
    """

    def __init__(self, service: "JobService", handle: JobHandle):
        self.service = service
        self.handle = handle

    @property
    def job_id(self) -> int:
        return self.handle.job_id

    @property
    def status(self) -> JobStatus:
        return self.handle.status

    def done(self) -> bool:
        return self.handle.done

    async def result(self) -> JobResult:
        h = self.handle
        while not h.done:
            if not self.service._pending():
                raise RuntimeError(
                    f"job {h.job.name!r} cannot make progress"
                )
            self.service._pump()
            await asyncio.sleep(0)
        if h.status is JobStatus.FAILED:
            raise h.error
        return h.result

    def __await__(self):
        return self.result().__await__()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP item "
        f"{item})"
    )


class JobService:
    """Multi-tenant job service over one shared TVM.

    ``capacity`` is the slot budget a wave's quotas must fit in;
    ``max_jobs`` bounds a wave's fan-in; ``dispatch``/``coalesce`` select
    the phase-2 policy for the fused fleet as on ``HostEngine``
    (``masked``, ``compacted``, ``gather``); ``pop_policy``/``gang`` pick
    the multi-stack pop policy (host engine).  ``engine="device"`` runs
    each wave resident (masked or gather, every live region each epoch)
    with ``stack_depth``, a chunk of ``chunk`` epochs (``None``: the whole
    wave), ``template_cache`` (a fresh :class:`WaveTemplateCache` unless
    given) and ``megakernel``.  ``device=None`` means CUDA (and raises
    where CUDA is absent); pass ``device="cpu"`` to run the plain PyTorch
    versions on the CPU.  ``classes``/``admission``/``preemption``/
    ``evict_over_deadline``/``clock`` configure the admission layer.
    """

    def __init__(
        self,
        capacity: int = 1 << 14,
        max_jobs: int = 8,
        dispatch: Any = "masked",
        coalesce: bool = True,
        pop_policy: Any = "fuse_all",
        gang: int = 0,
        default_quota: int = 1 << 10,
        collect_stats: bool = True,
        engine: str = "host",
        stack_depth: int = 1 << 10,
        chunk: Optional[int] = None,
        template_cache: Optional[WaveTemplateCache] = None,
        megakernel: bool = False,
        device=None,
        metrics=None,
        tracer=None,
        classes: Optional[List[QuotaClass]] = None,
        admission: Optional[AdmissionController] = None,
        preemption: bool = True,
        evict_over_deadline: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ):
        if engine not in ("host", "device", "sharded"):
            raise ValueError(
                "engine must be 'host', 'device' or 'sharded', "
                f"got {engine!r}"
            )
        if engine == "sharded":
            raise _not_ported(
                "JobService(engine='sharded'), the sharded fleet", "9")
        if dispatch == "auto":
            raise _not_ported("dispatch='auto' (the dispatch controller)",
                              "8")
        if metrics is not None or tracer is not None:
            raise _not_ported("the metrics and tracer hooks", "8")
        if engine == "device":
            check_resident_options(dispatch, chunk)
            if gang or pop_policy != "fuse_all":
                raise ValueError(
                    "engine='device' runs every live region each epoch "
                    "(fuse_all); gang/pop_policy are host-engine options"
                )
        elif chunk is not None:
            raise ValueError(
                "chunk sets the resident readback cadence; it requires "
                "engine='device' (the host engine reads back every epoch)"
            )
        elif megakernel:
            raise ValueError(
                "megakernel fuses the resident chunk loop; it requires "
                "engine='device' (the host engine has no resident loop)"
            )
        self.engine = engine
        self.stack_depth = stack_depth
        self.chunk = chunk
        self.megakernel = bool(megakernel)
        self.template_cache = (
            template_cache if template_cache is not None
            else WaveTemplateCache()
        )
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_jobs = max_jobs
        self.dispatch = dispatch
        self.coalesce = coalesce
        self.pop_policy = pop_policy
        self.gang = gang
        self.default_quota = default_quota
        self.collect_stats = collect_stats
        # admission layer: an explicit controller wins (its clock becomes
        # the service clock so handle stamps and deadlines share a base)
        if admission is not None:
            self.admission = admission
            self._clock = admission.clock
        else:
            self.admission = AdmissionController(
                classes=classes, clock=clock,
                evict_over_deadline=evict_over_deadline,
            )
            self._clock = clock
        self.preemption = bool(preemption)
        self._ids = itertools.count()
        self._queue: List[JobHandle] = []
        self._mux = None  # the live wave's EpochMultiplexer/DeviceMultiplexer
        # the last finished host wave, kept until the next wave takes over
        # its loop and buffers (EpochMultiplexer._adopt)
        self._last = None
        self._stats = RunStats()
        self._admit_ready = False  # a region was freed since the last scan

    # ------------------------------------------------------------- submit
    def submit(
        self,
        program: Program,
        initial: InitialTask,
        heap_init: Optional[Mapping[str, Any]] = None,
        quota: Optional[int] = None,
        name: str = "",
        priority: int = 0,
        deadline: Optional[float] = None,
        klass: str = "default",
    ) -> JobHandle:
        """Admit a job into the queue; raises AdmissionError if it can
        never run on this service.  ``deadline`` is relative seconds from
        now on the service clock; ``klass`` names a configured
        :class:`QuotaClass`."""
        job = Job(
            program=program,
            initial=initial,
            heap_init=dict(heap_init or {}),
            quota=int(quota or self.default_quota),
            name=name or program.name,
        )
        validate_job(job, self.capacity)
        if klass not in self.admission.classes:
            raise AdmissionError(
                f"job {job.name!r}: unknown quota class {klass!r} "
                f"(known: {sorted(self.admission.classes)})"
            )
        handle = JobHandle(
            job_id=next(self._ids), job=job, clock=self._clock,
            priority=int(priority),
            deadline=(
                None if deadline is None else self._clock() + deadline
            ),
            klass=klass,
        )
        self._queue.append(handle)
        return handle

    def submit_case(self, case, quota: Optional[int] = None,
                    name: str = "", **kw) -> JobHandle:
        """Submit a registered :class:`~repro_torch.apps.registry.AppCase`."""
        return self.submit(
            case.program,
            case.initial,
            heap_init=dict(case.heap_init),
            quota=quota or case.capacity,
            name=name or case.name,
            **kw,
        )

    def submit_async(self, *args, **kw) -> JobFuture:
        """:meth:`submit`, wrapped in an awaitable :class:`JobFuture`."""
        return JobFuture(self, self.submit(*args, **kw))

    # -------------------------------------------------------------- query
    def poll(self, handle: JobHandle) -> JobStatus:
        return handle.status

    def result(self, handle: JobHandle) -> JobResult:
        """Drive the service until this job finishes; raise on failure."""
        while not handle.done:
            if not self._pending():
                raise RuntimeError(
                    f"job {handle.job.name!r} cannot make progress"
                )
            self._pump()
        if handle.status is JobStatus.FAILED:
            raise handle.error
        return handle.result

    # ------------------------------------------------------------- driving
    def completions(self) -> Iterator[JobHandle]:
        """Stream handles as they complete (DONE or FAILED)."""
        while self._pending():
            for h in self._pump():
                yield h

    def drain(self) -> List[JobHandle]:
        """Run every submitted job to completion; return all handles in
        completion order."""
        return list(self.completions())

    async def stream_results(self) -> AsyncIterator[JobHandle]:
        """Async face of :meth:`completions`, ceding the event loop
        between pumps."""
        while self._pending():
            for h in self._pump():
                yield h
            await asyncio.sleep(0)

    def preempt(self, handle: JobHandle) -> bool:
        """Preempt one running job now: lift it into its checkpoint,
        re-queue it, free its region.  Returns False if the job is not
        currently seated."""
        if self._mux is None or not self._mux.preempt(handle):
            return False
        self.admission.note_preempted(handle)
        self._queue.append(handle)
        self._admit_ready = True
        return True

    def stats(self) -> RunStats:
        """Fleet-level stats accumulated across every wave so far."""
        total = merge_stats(RunStats(), self._stats)
        if self._mux is not None:
            merge_stats(total, self._mux.stats())
        return total

    @property
    def trace_count(self) -> int:
        """Resident bodies built across every device wave template: an
        identical consecutive wave must leave it unchanged."""
        return self.template_cache.trace_count

    # ------------------------------------------------------------ internal
    def _pending(self) -> bool:
        return bool(self._queue) or (self._mux is not None and self._mux.live)

    def _pump(self) -> List[JobHandle]:
        """Make one unit of progress: (re)build or refill the fleet, then
        run one fused global epoch.  Returns newly completed handles."""
        if self._mux is not None and not self._mux.live:
            merge_stats(self._stats, self._mux.stats())
            self._last, self._mux = self._mux, None
        if self._mux is None:
            wave = self._take_wave()
            if not wave:
                return []
            if self.engine == "device":
                self._mux = self._device_wave(wave)
            else:
                self._mux = EpochMultiplexer(
                    wave,
                    dispatch=self.dispatch,
                    coalesce=self.coalesce,
                    pop_policy=self.pop_policy,
                    gang=self.gang,
                    collect_stats=self.collect_stats,
                    device=self.device,
                )
                # a wave of the last one's layout runs on its loop, graphs
                # and buffers, as the device engine's on its template
                if isinstance(self._last, EpochMultiplexer):
                    self._mux._adopt(self._last)
            self._last = None
            self._admit_ready = False
        elif self._admit_ready and self._queue:
            # streaming admission: a region frees only at a completion or
            # a preemption, so scan the queue only after one
            self._admit_queued()
            self._admit_ready = False
        done = self._mux.step()
        if done:
            self._admit_ready = True
            for h in done:
                self.admission.note_finished(h)
        # preemption: seat what free regions absorb first, then ask the
        # admission layer who must yield for whoever is still stuck
        if self.preemption and self._queue and self._mux.live:
            self._admit_queued()
            victims = self.admission.plan_preemptions(
                self._mux.running_handles(), self._queue
            ) if self._queue else []
            for v in victims:
                if self._mux.preempt(v):
                    self.admission.note_preempted(v)
                    self._queue.append(v)
                    self._admit_ready = True
        return done

    def _device_wave(self, wave: List[JobHandle]) -> DeviceMultiplexer:
        """A resident wave: members seated in canonical order (so a
        permutation of an earlier wave lands on its cached template's slot
        layout), the template looked up by the wave's key, stored on a
        miss."""
        order = canonical_wave_order([h.job for h in wave])
        wave = [wave[i] for i in order]
        jobs = [h.job for h in wave]
        dispatch = resolve_policy(self.dispatch).name
        key = wave_template_key(
            jobs, sum(j.quota for j in jobs), self.stack_depth, self.chunk,
            dispatch=dispatch, megakernel=self.megakernel,
        )
        tpl = self.template_cache.lookup(key)
        mux = DeviceMultiplexer(
            wave,
            dispatch=dispatch,
            stack_depth=self.stack_depth,
            chunk=self.chunk,
            collect_stats=self.collect_stats,
            template=tpl,
            megakernel=self.megakernel,
            device=self.device,
        )
        if tpl is None:
            self.template_cache.store(WaveTemplate(
                key=key, program=mux.program, slots=mux.slots,
                loop=mux.loop))
        return mux

    def _admit_queued(self) -> int:
        """Seat queued jobs into free regions of the live wave, in
        admission order, consuming class rate tokens per seat."""
        seated = 0
        still: List[JobHandle] = []
        for h in self.admission.order(self._queue):
            if (
                self.admission.has_token(h)
                and self._mux.admit(h)
                and self.admission.allow(h)
            ):
                seated += 1
            else:
                still.append(h)
        still.sort(key=lambda h: h.job_id)
        self._queue = still
        return seated

    def _take_wave(self) -> List[JobHandle]:
        """Assemble the next wave (the admission layer's first-fit in
        priority, EDF and FIFO order)."""
        wave, self._queue = self.admission.take_wave(
            self._queue, self.capacity, self.max_jobs
        )
        return wave
