"""Execution surface of the serving front door (PyTorch port of
``repro/service/api.py``).

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
``epoch_chunk`` launch) or across the P shards of a
:class:`~repro_torch.distributed.fleet.ShardedFleet` (``engine="sharded"``,
``shards``, ``placement``, ``rebalance``: P copies of one wave's slot
layout, one collective chunk and one readback a step, the whole queue
streaming into the shards' placement queues).  A device or sharded wave's
members are seated in
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

Control and telemetry, as in the reference: ``dispatch="auto"`` keeps
one :class:`~repro_torch.control.controller.DispatchController` on the
service (per-epoch decisions on the host engine; one resolution per new
wave shape on the device engine, sticky through the template cache),
calibrated by default with
:meth:`~repro_torch.control.controller.CostModel.calibrated` on the
service's device; ``chunk="auto"`` one ``ChunkController`` fed by the
service's queue probe; ``placement="auto"`` (sharded engine) one
``PlacementController``; ``metrics`` (a ``MetricsRegistry``) gets each
wave's run series (with a ``shard`` label on the sharded engine) and the
per-tenant lifecycle, deadline, preemption and template-cache series;
``tracer`` gets the wave drivers' spans.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import (
    Any, AsyncIterator, Callable, Iterator, List, Mapping, Optional,
)

from ..core.engine import resolve_device, resolve_resident_dispatch
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
    given) and ``megakernel``.  ``engine="sharded"`` runs each wave as a
    :class:`~repro_torch.distributed.fleet.ShardedFleet` of ``shards``
    shards with the device engine's options: ``placement``
    (``round_robin`` / ``least_loaded`` / ``sticky`` / ``auto``) assigns
    queued jobs to shards and ``rebalance`` migrates them off hot shards
    at chunk boundaries; per-job results stay bit-identical to solo at
    every P.  ``device=None`` means CUDA (and raises
    where CUDA is absent); pass ``device="cpu"`` to run the plain PyTorch
    versions on the CPU.  ``classes``/``admission``/``preemption``/
    ``evict_over_deadline``/``clock`` configure the admission layer.

    ``dispatch="auto"`` and ``chunk="auto"`` (device engine) hand the
    mode and K to controllers kept on the service, so what they learn
    carries across waves; ``calibrate`` (default on) seeds the dispatch
    controller with a :meth:`~repro_torch.control.controller.CostModel.
    calibrated` micro-probe of the service's device, cached per process.
    ``metrics`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`) and
    ``tracer`` (a :class:`~repro_torch.obs.trace.SpanTracer`) are opt-in.
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
        chunk: Any = None,
        template_cache: Optional[WaveTemplateCache] = None,
        megakernel: bool = False,
        device=None,
        metrics=None,
        tracer=None,
        shards: int = 1,
        placement: str = "round_robin",
        rebalance: bool = True,
        calibrate: bool = True,
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
            from ..distributed.fleet import PLACEMENTS

            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            if placement not in PLACEMENTS + ("auto",):
                raise ValueError(
                    f"placement must be one of {PLACEMENTS + ('auto',)}, "
                    f"got {placement!r}"
                )
        elif shards != 1:
            raise ValueError(
                "shards requires engine='sharded' (host/device waves run "
                f"one TVM); got shards={shards}"
            )
        if engine in ("device", "sharded"):
            check_resident_options(dispatch, chunk)
            if gang or pop_policy != "fuse_all":
                raise ValueError(
                    f"engine={engine!r} runs every live region each epoch "
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
        self.shards = int(shards)
        self.placement = placement
        self.rebalance = bool(rebalance)
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
        # observability (DESIGN.md §13), both opt-in: ``metrics`` is a
        # MetricsRegistry fed with per-wave run series (via the collector
        # adapter) and the per-tenant job lifecycle series below; ``tracer``
        # receives epoch/chunk span timelines from the wave drivers
        self.metrics = metrics
        self.tracer = tracer
        # self-tuning (DESIGN.md §14): the controllers live on the service
        # so what they learn carries across waves.  The dispatch controller
        # is shared by every wave's loop (host: per-epoch decisions;
        # device: one resolution per new wave shape, sticky via the
        # template cache); the chunk controller owns K across waves.
        self.controller = None
        if resolve_policy(dispatch).name == "auto":
            from ..control.controller import CostModel, DispatchController

            # calibrate by default: the controller's priors come from a
            # one-shot micro-probe of the service's device (process-cached,
            # so only the first service pays it)
            cost = (CostModel.calibrated(device=self.device) if calibrate
                    else None)
            self.controller = DispatchController(cost=cost)
            if metrics is not None:
                self.controller.bind_registry(
                    metrics, driver=engine, app="service"
                )
        self.chunk_controller = None
        if chunk == "auto":
            from ..control.controller import ChunkController

            self.chunk_controller = ChunkController()
            if metrics is not None:
                self.chunk_controller.bind_registry(metrics, app="service")
        # placement="auto" (sharded): the controller lives here so its
        # workload-mix window carries across waves, like the K controller
        self.placement_controller = None
        if engine == "sharded" and placement == "auto":
            from ..control.controller import PlacementController

            self.placement_controller = PlacementController()
            if metrics is not None:
                self.placement_controller.bind_registry(
                    metrics, app="service"
                )
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
        # the live wave: an EpochMultiplexer, DeviceMultiplexer or
        # ShardedFleet
        self._mux = None
        # the last finished host wave, kept until the next wave takes over
        # its loop and buffers (EpochMultiplexer._adopt)
        self._last = None
        self._stats = RunStats()
        self._admit_ready = False  # a region was freed since the last scan

    # ------------------------------------------------------- observability
    def _stats_factory(self):
        """Per-wave collector factory: the plain collector when metrics are
        off (the disabled path allocates nothing extra), the registry
        adapter around it when on.  The sharded engine calls it with each
        shard's index, which labels every series ``shard`` (a registry
        pins labelnames per metric name, so keep one registry per engine
        flavour)."""
        if self.metrics is None:
            return None
        from ..core.scheduler import NullStats, RunStatsCollector
        from ..obs.metrics import MetricsCollector

        registry = self.metrics
        driver = self.engine
        dispatch = resolve_policy(self.dispatch).name
        collect = self.collect_stats

        def factory(p: Optional[int] = None):
            inner = RunStatsCollector() if collect else NullStats()
            return MetricsCollector(
                inner, registry, driver=driver, dispatch=dispatch,
                app="service", shard=None if p is None else str(p),
            )

        return factory

    def _observe_completions(self, done: List[JobHandle]) -> None:
        """Record deadline outcomes with the admission layer and feed the
        per-tenant/per-class lifecycle series for newly finished jobs:
        queue-wait and run-time latency histograms, completion counters by
        terminal status, and the per-class deadline scoreboard."""
        # admission accounting happens with or without a registry
        outcomes = {
            h.job_id: self.admission.note_finished(h) for h in done
        }
        if self.metrics is None or not done:
            return
        r = self.metrics
        lab = ("tenant",)
        qw = r.histogram(
            "trees_job_queue_wait_seconds",
            "seconds from submit to first co-scheduled epoch", lab,
        )
        rt = r.histogram(
            "trees_job_run_seconds",
            "seconds from first co-scheduled epoch to completion", lab,
        )
        fin = r.counter(
            "trees_jobs_finished_total",
            "jobs reaching a terminal status", ("tenant", "status"),
        )
        # per-class series (new names: the registry pins labelnames per
        # metric, so class-labeled series cannot share the tenant ones)
        cqw = r.histogram(
            "trees_class_queue_wait_seconds",
            "queue wait by quota class", ("klass",),
        )
        dmiss = r.counter(
            "trees_deadline_misses_total",
            "deadlined jobs finishing past their deadline", ("klass",),
        )
        dmet = r.counter(
            "trees_deadlines_met_total",
            "deadlined jobs finishing in time", ("klass",),
        )
        ratio = r.gauge(
            "trees_deadline_miss_ratio",
            "misses / (misses + met) per quota class", ("klass",),
        )
        for h in done:
            tenant = h.job.name or h.job.program.name
            if h.queue_wait is not None:
                qw.labels(tenant=tenant).observe(h.queue_wait)
                cqw.labels(klass=h.klass).observe(h.queue_wait)
            if h.run_time is not None:
                rt.labels(tenant=tenant).observe(h.run_time)
            fin.labels(tenant=tenant, status=h.status.value).inc()
            met = outcomes[h.job_id]
            if met is True:
                dmet.labels(klass=h.klass).inc()
            elif met is False:
                dmiss.labels(klass=h.klass).inc()
            if met is not None:
                ratio.labels(klass=h.klass).set(
                    self.admission.miss_ratio(h.klass)
                )
        # completions follow the wave's builds, so the trace-count gauge
        # set at lookup time is refreshed here with what the wave built
        r.gauge(
            "trees_wave_template_traces",
            "traced builder bodies across all wave templates",
        ).labels().set(self.template_cache.trace_count)

    def _observe_preemption(self, h: JobHandle) -> None:
        """Count one executed preemption, labeled by quota class."""
        if self.metrics is None:
            return
        self.metrics.counter(
            "trees_job_preemptions_total",
            "running jobs checkpointed and re-queued at a chunk boundary",
            ("klass",),
        ).labels(klass=h.klass).inc()

    def _observe_template_cache(self, hit: bool) -> None:
        """Mirror the wave-template cache's reuse counters into the
        registry (hit/miss per wave build, LRU evictions, plus the
        monotone trace-count gauge)."""
        if self.metrics is None:
            return
        r = self.metrics
        r.counter(
            "trees_wave_template_lookups_total",
            "wave-template cache lookups", ("outcome",),
        ).labels(outcome="hit" if hit else "miss").inc()
        r.gauge(
            "trees_wave_template_evictions",
            "wave templates LRU-evicted from the cache so far",
        ).labels().set(self.template_cache.evictions)
        r.gauge(
            "trees_wave_template_traces",
            "traced builder bodies across all wave templates",
        ).labels().set(self.template_cache.trace_count)

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
        self._observe_preemption(handle)
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
    def _queue_probe(self):
        """Queue-heat signal for the chunk controller: (queued jobs, the
        oldest queued job's wait in seconds, seconds of slack to the
        nearest outstanding deadline)."""
        running = (
            self._mux.running_handles() if self._mux is not None else ()
        )
        slack = self.admission.deadline_slack(self._queue, running)
        if not self._queue:
            return (0, 0.0, slack)
        now = self._clock()
        return (
            len(self._queue),
            max(now - h.submitted_at for h in self._queue),
            slack,
        )

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
            if self.engine in ("device", "sharded"):
                self._mux = self._device_wave(wave)
            else:
                self._mux = EpochMultiplexer(
                    wave,
                    dispatch=self.dispatch,
                    coalesce=self.coalesce,
                    pop_policy=self.pop_policy,
                    gang=self.gang,
                    collect_stats=self.collect_stats,
                    stats_factory=self._stats_factory(),
                    device=self.device,
                    tracer=self.tracer,
                    controller=self.controller,
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
            self._observe_completions(done)
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
                    self._observe_preemption(v)
                    self._queue.append(v)
                    self._admit_ready = True
        return done

    def _device_wave(self, wave: List[JobHandle]):
        """A resident wave: members seated in canonical order (so a
        permutation of an earlier wave lands on its cached template's slot
        layout), ``dispatch="auto"`` resolved (a cached template's mode
        wins before the controller is asked), the template looked up by
        the wave's key, stored on a miss.  On the sharded engine the wave
        is a :class:`~repro_torch.distributed.fleet.ShardedFleet` of that
        template (the key is not a function of P: every shard replicates
        the one wave's layout), and the whole queue streams into its
        placement queues."""
        order = canonical_wave_order([h.job for h in wave])
        wave = [wave[i] for i in order]
        jobs = [h.job for h in wave]
        cap = sum(j.quota for j in jobs)

        def peek(cand: str):
            # sticky per wave shape: an identical consecutive wave never
            # rebuilds on a flipped decision; a new shape falls through to
            # the controller's window, accumulated across waves
            return self.template_cache.peek(wave_template_key(
                jobs, cap, self.stack_depth, self.chunk,
                dispatch=cand, megakernel=self.megakernel,
            ))

        dispatch = resolve_policy(resolve_resident_dispatch(
            self.dispatch, self.controller, cap, peek=peek)).name
        key = wave_template_key(
            jobs, cap, self.stack_depth, self.chunk,
            dispatch=dispatch, megakernel=self.megakernel,
        )
        tpl = self.template_cache.lookup(key)
        self._observe_template_cache(hit=tpl is not None)
        if self.engine == "sharded":
            from ..distributed.fleet import ShardedFleet

            mux = ShardedFleet(
                wave,
                shards=self.shards,
                dispatch=dispatch,
                stack_depth=self.stack_depth,
                chunk=self.chunk,
                placement=self.placement,
                placement_controller=self.placement_controller,
                rebalance=self.rebalance,
                collect_stats=self.collect_stats,
                stats_factory=self._stats_factory(),
                template=tpl,
                megakernel=self.megakernel,
                device=self.device,
                tracer=self.tracer,
                controller=self.controller,
                chunk_controller=self.chunk_controller,
                queue_probe=self._queue_probe,
            )
            # the anchor wave sized ONE shard's layout; the other P - 1
            # shards start vacant and fill from the queue here (and from
            # later submits through streaming admission)
            self._queue = [h for h in self._queue if not mux.admit(h)]
            if tpl is None:
                self.template_cache.store(dataclasses.replace(
                    mux.template, key=key))
            return mux
        mux = DeviceMultiplexer(
            wave,
            dispatch=dispatch,
            stack_depth=self.stack_depth,
            chunk=self.chunk,
            collect_stats=self.collect_stats,
            stats_factory=self._stats_factory(),
            template=tpl,
            megakernel=self.megakernel,
            device=self.device,
            tracer=self.tracer,
            controller=self.controller,
            chunk_controller=self.chunk_controller,
            queue_probe=self._queue_probe,
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
