"""Sharded fleet execution (DESIGN.md §15; PyTorch port of
``repro/distributed/fleet.py``).

A *fleet* is P independent TVM shards, each a full scheduler-stack + arena
+ :class:`~repro_torch.core.engine.ResidentCarry` block, i.e. exactly one
:class:`~repro_torch.service.multiplexer.DeviceMultiplexer` wave, advanced
together:

* **One collective chunk.**
  :meth:`~repro_torch.core.engine.EpochLoop.run_chunk_fleet` runs every
  shard's resident chunk, each shard bounded by its *own* epoch limit: on
  the card with ``megakernel=True`` one ``epoch_chunk`` launch a shard,
  else the plain fleet loop, shard after shard on one device.  A shard with
  no rider is not launched.

* **One readback per collective chunk.**  Every shard's
  :class:`~repro_torch.core.engine.ChunkSummary` scalars come back in one
  transfer (:meth:`EpochLoop.fleet_chunk_summaries`), so a fleet advancing
  K epochs pays ⌈E/K⌉ readbacks *total*, not per shard; ``stats()`` counts
  dispatches and transfers per collective step, as the reference does
  (``kernels.counters`` counts the real ``epoch_chunk`` launches).

* **Chunk-boundary work rebalancing.**  Jobs are placed on shards by a
  policy (``round_robin`` / ``least_loaded`` / ``sticky``, or ``auto``:
  a :class:`~repro_torch.control.controller.PlacementController` picks one
  per job); at each boundary, queued jobs stuck on a *hot* shard (no free
  compatible region) migrate to an *idle* shard (a free region, least load:
  queue depth, live regions, the last summary's stack pointers) and seat
  through the shard's ``admit`` → ``_seed_region`` path, the path
  mid-flight admission always uses.

Every shard shares ONE wave template (fused program, slot layout and
loop).  A shard region without a tenant is *vacant* (``handle=None``,
sp=0, inert) until a job seats into it.  Per-job execution inside a shard
region is exactly the solo region execution, so per-job results are
bit-identical to a solo run at every P, every placement and every
migration history.

Each shard keeps its own in-place carry, so the reference's plumbing for
immutable, cross-device stacked arrays (``_view``, ``_stacked``,
``_ensure_host``, ``_fresh``, ``_attached``: host snapshots of the
stacked carry and restacks after a reseed) has no counterpart here.  The
multi-device form (shard ``p`` on its own device, the reference's
``shard_map`` mesh and its ``mesh`` argument) is not ported: a fleet on
the card asks :func:`~repro_torch.launch.mesh.make_fleet_mesh`, which
raises where it would apply.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..core.engine import (
    EpochLoop,
    resolve_device,
    resolve_resident_dispatch,
)
from ..core.scheduler import RunStats
from ..obs.trace import NULL_TRACER
from ..service.jobs import (
    Job,
    JobHandle,
    WaveTemplate,
    canonical_wave_order,
)
from ..service.multiplexer import DeviceMultiplexer, fuse_programs

PLACEMENTS = ("round_robin", "least_loaded", "sticky")


def _type_key(job: Job) -> int:
    """Stable integer from a job's structural hash (sticky placement)."""
    h = job.program.structural_hash()
    try:
        return int(h, 16)
    except ValueError:
        return abs(hash(h))


class ShardWave(DeviceMultiplexer):
    """One shard: a DeviceMultiplexer wave whose regions all start vacant.

    Construction seats nobody: the fleet seats every tenant (initial and
    migrated alike) through ``admit``'s reseed path against the carry
    built here, all vacant.  The chunk itself is not driven here: the
    fleet runs every shard's chunk in one collective step, then hands each
    shard its own summary through ``_finish_chunk``.
    """

    def __init__(self, template: WaveTemplate, **kw):
        super().__init__(
            handles=[None] * len(template.slots), template=template, **kw
        )
        self._ensure_carry()

    def _admits_midflight(self) -> bool:
        # admission gating is the fleet's job: shards only ever seat
        # tenants at collective boundaries, where every region is either
        # between chunks or drained, so a shard admits even at chunk=None
        return self._carry is not None

    @property
    def live_regions(self) -> int:
        return sum(1 for r in self._regions if r.running)


class ShardedFleet:
    """P TVM shards advancing together: one collective chunk and one
    readback per step (DESIGN.md §15).

    ``handles`` is the *anchor wave*: its jobs (in canonical order) define
    the per-shard slot layout replicated across all P shards, and are then
    placed like any later admission.  ``admit`` accepts any job
    structurally compatible with that layout: placement queues it on a
    shard, and it seats at the next collective boundary.  Drive with
    :meth:`step` / :meth:`run`; completions stream per boundary exactly as
    from one ``DeviceMultiplexer`` wave.

    ``rebalance=False`` pins every job to its placed shard; the default
    migrates queued jobs off hot shards at boundaries and counts each move
    in ``migrations``.  ``device=None`` means CUDA (and raises where CUDA
    is absent); pass ``device="cpu"`` for the CPU.  ``tracer`` receives a
    ``collective_chunk`` span per step (tid 3) with its ``dispatch`` and
    ``readback`` children and one ``chunk`` span per riding shard (tid
    10 + p); the dispatch runs under the ``trees:fleet_chunk`` annotation.
    """

    def __init__(
        self,
        handles: Sequence[JobHandle],
        shards: int,
        *,
        dispatch: Any = "masked",
        stack_depth: int = 1 << 10,
        chunk: Any = None,
        placement: str = "round_robin",
        placement_controller=None,
        rebalance: bool = True,
        collect_stats: bool = True,
        stats_factory: Optional[Callable[[int], Any]] = None,
        template: Optional[WaveTemplate] = None,
        megakernel: bool = False,
        device=None,
        tracer=None,
        controller=None,
        chunk_controller=None,
        queue_probe=None,
    ):
        if shards < 1:
            raise ValueError(f"a fleet needs >= 1 shard, got {shards}")
        if placement not in PLACEMENTS + ("auto",):
            raise ValueError(
                f"placement must be one of {PLACEMENTS + ('auto',)}, "
                f"got {placement!r}"
            )
        if not handles:
            raise ValueError("ShardedFleet needs at least one anchor job")
        self.shards = int(shards)
        self.placement = placement
        self.device = resolve_device(device)
        self._pctl = None
        if placement == "auto":
            from ..control.controller import PlacementController

            self._pctl = placement_controller or PlacementController()
        self.rebalance = bool(rebalance)
        self.tracer = tracer or NULL_TRACER
        self.migrations = 0
        self.collective_steps = 0

        order = canonical_wave_order([h.job for h in handles])
        anchors = [handles[i] for i in order]
        jobs = [h.job for h in anchors]
        self.capacity = sum(j.quota for j in jobs)  # per shard

        dispatch = resolve_resident_dispatch(
            dispatch, controller, self.capacity
        )
        if template is None:
            program, slots = fuse_programs(
                [j.program for j in jobs], [j.quota for j in jobs]
            )
            template = WaveTemplate(
                key=("fleet-anon",),
                program=program,
                slots=slots,
                loop=EpochLoop(program, dispatch, megakernel=megakernel,
                               tenants=slots),
            )
        self.template = template
        self._loop = template.loop
        self.chunk = chunk
        self._kctl = None
        if chunk == "auto":
            from ..control.controller import ChunkController

            self._kctl = chunk_controller or ChunkController()
        self._queue_probe = queue_probe
        self._shards: List[ShardWave] = [
            ShardWave(
                template,
                dispatch=dispatch,
                stack_depth=stack_depth,
                chunk=chunk,
                collect_stats=collect_stats,
                stats_factory=(
                    None if stats_factory is None
                    else (lambda _p=p: stats_factory(_p))
                ),
                megakernel=megakernel,
                device=self.device,
                controller=controller,
                chunk_controller=self._kctl,
            )
            for p in range(self.shards)
        ]
        self.policy = self._shards[0].policy
        self._slot_types = [
            (s.program.structural_hash(), s.quota) for s in template.slots
        ]
        self.mesh = None
        if self.device.type == "cuda":
            from ..launch.mesh import make_fleet_mesh

            self.mesh = make_fleet_mesh(self.shards)  # None, or raises
        self._pending: List[List[JobHandle]] = [
            [] for _ in range(self.shards)
        ]
        self._rr = 0
        self._last_sp: List[Optional[np.ndarray]] = [None] * self.shards
        # fleet-level V_inf: ONE collective step and ONE readback per
        # chunk, however many shards rode it
        self._dispatches = 0
        self._transfers = 0

        for h in anchors:
            if not self.admit(h):
                raise ValueError(
                    f"anchor job {h.job.name!r} does not fit the fleet "
                    "layout it defined"
                )

    # ----------------------------------------------------------- placement
    def compatible(self, job: Job) -> bool:
        """Whether this layout can ever run the job (structural equality
        with some slot template, quota within the slot)."""
        h = job.program.structural_hash()
        return any(h == sh and job.quota <= q for sh, q in self._slot_types)

    def _load(self, p: int):
        """Shard load, least-first comparable: queued jobs, live regions,
        and the last summary's remaining stack entries."""
        sp = self._last_sp[p]
        return (
            len(self._pending[p]),
            self._shards[p].live_regions,
            0 if sp is None else int(sp.sum()),
        )

    def _place(self, job: Job) -> int:
        policy = self.placement
        if self._pctl is not None:
            # placement="auto": the controller re-picks the concrete
            # policy per job from the observed workload mix
            self._pctl.observe_job(_type_key(job))
            policy = self._pctl.choose()
        if policy == "sticky":
            return _type_key(job) % self.shards
        if policy == "least_loaded":
            return min(range(self.shards), key=self._load)
        p = self._rr
        self._rr = (self._rr + 1) % self.shards
        return p

    def admit(self, handle: JobHandle) -> bool:
        """Queue a job on its placed shard (False if the layout can never
        run it).  Seating, including any rebalancing migration, happens at
        the next collective boundary."""
        if not self.compatible(handle.job):
            return False
        self._pending[self._place(handle.job)].append(handle)
        return True

    def _free_region(self, p: int, job: Job) -> bool:
        h = job.program.structural_hash()
        return any(
            r.handle is None
            and job.quota <= r.slot.quota
            and (
                r.slot.program is job.program
                or r.slot.program.structural_hash() == h
            )
            for r in self._shards[p]._regions
        )

    def _seat_pending(self) -> int:
        """Seat queued jobs on their shards; then (rebalance) migrate jobs
        stuck on hot shards to idle shards with free compatible regions.
        Every seat goes through the shard's admit → ``_seed_region`` (or,
        for a preempted job, ``_restore_region``) path."""
        seated = 0
        for p, sh in enumerate(self._shards):
            if not self._pending[p]:
                continue
            rest: List[JobHandle] = []
            for h in self._pending[p]:
                if sh.admit(h):
                    seated += 1
                else:
                    rest.append(h)
            self._pending[p] = rest
        if self.rebalance:
            for p in range(self.shards):
                if not self._pending[p]:
                    continue
                rest = []
                for h in self._pending[p]:
                    cands = [
                        q for q in range(self.shards)
                        if q != p and self._free_region(q, h.job)
                    ]
                    tgt = min(cands, key=self._load) if cands else None
                    if tgt is not None and self._shards[tgt].admit(h):
                        self.migrations += 1
                        seated += 1
                    else:
                        rest.append(h)
                self._pending[p] = rest
        return seated

    # ------------------------------------------------------------- driving
    @property
    def live(self) -> bool:
        return (
            any(sh.live for sh in self._shards)
            or any(self._pending)
        )

    @property
    def loop(self) -> EpochLoop:
        return self._loop

    @property
    def slots(self):
        return list(self.template.slots)

    def step(self, max_epochs: int = 1 << 20) -> List[JobHandle]:
        """One collective chunk: seat/rebalance queued jobs, advance every
        live shard by (at most) K epochs, read every shard's summary back
        in one transfer, then settle each shard's riders."""
        self._seat_pending()
        riders = [
            [j for j, r in enumerate(sh._regions) if r.running]
            for sh in self._shards
        ]
        if not any(riders):
            return []
        limits = np.asarray(
            [
                sh._chunk_limit(max_epochs) if riders[p] else 0
                for p, sh in enumerate(self._shards)
            ],
            np.int32,
        )
        J = len(self.template.slots)
        self.collective_steps += 1
        tr = self.tracer
        if tr.enabled:
            tr.thread(3, "fleet")
            for p in range(self.shards):
                tr.thread(10 + p, f"shard{p}")
        with tr.span(
            "collective_chunk", "fleet", tid=3,
            seq=self.collective_steps, shards=self.shards,
            jobs=sum(len(r) for r in riders),
            mode=self.policy.name,
            mesh=self.mesh is not None,
        ):
            with tr.span("dispatch", "fleet", tid=3), tr.annotation(
                "trees:fleet_chunk"
            ):
                carries = self._loop.run_chunk_fleet(
                    [sh._carry for sh in self._shards], limits, n_regions=J
                )
            for sh, c in zip(self._shards, carries):
                sh._attach_carry(c)
            with tr.span("readback", "fleet", tid=3):
                summaries = self._loop.fleet_chunk_summaries(carries)
        self._dispatches += 1
        self._transfers += 1
        done: List[JobHandle] = []
        for p, sh in enumerate(self._shards):
            s = summaries[p]
            self._last_sp[p] = s.sp
            if not riders[p]:
                continue
            done.extend(sh._finish_chunk(s, riders[p], max_epochs))
            if tr.enabled:
                with tr.span(
                    "chunk", "fleet", tid=10 + p, shard=p,
                    jobs=len(riders[p]), **sh.last_deltas,
                ):
                    pass
        # controller feedback, ONCE per collective boundary: the fleet
        # queue is its internal shard queues plus whatever external queue
        # the service reports (the probe's optional third element is the
        # admission layer's nearest-deadline slack)
        if self._pctl is not None:
            loads = [len(q) for q in self._pending]
            self._pctl.observe_imbalance(
                self.utilization_spread(), max(loads) - min(loads)
            )
        if self._kctl is not None:
            queued = sum(len(q) for q in self._pending)
            oldest, slack = 0.0, None
            if self._queue_probe is not None:
                probe = self._queue_probe()
                queued += probe[0]
                oldest = probe[1]
                if len(probe) > 2:
                    slack = probe[2]
            if slack is None:
                self._kctl.observe(len(done), queued, oldest)
            else:
                self._kctl.observe(
                    len(done), queued, oldest, deadline_slack=slack
                )
        return done

    # ---------------------------------------------------------- preemption
    def running_handles(self) -> List[JobHandle]:
        out: List[JobHandle] = []
        for sh in self._shards:
            out.extend(sh.running_handles())
        return out

    def preempt(self, handle: JobHandle) -> bool:
        """Lift a running job off whichever shard holds it into its
        engine-agnostic checkpoint (the region goes vacant).  Works at
        collective boundaries, which is where the service calls it."""
        for sh in self._shards:
            if any(r.handle is handle and r.running for r in sh._regions):
                return sh.preempt(handle)
        return False

    def run(self, max_epochs: int = 1 << 20) -> List[JobHandle]:
        out: List[JobHandle] = []
        while self.live:
            got = self.step(max_epochs=max_epochs)
            out.extend(got)
            if not got and not any(sh.live for sh in self._shards):
                # queued jobs nobody can seat: impossible by construction
                # (compatible() gates admit), but never spin silently
                raise RuntimeError(
                    "sharded fleet wedged: queued jobs but no live or "
                    "seatable region"
                )
        return out

    # ----------------------------------------------------------- reporting
    def stats(self) -> RunStats:
        """Fleet totals: per-shard work counters summed, V_inf terms
        counted per *collective* step (P shards, one step and one
        readback a chunk)."""
        total = RunStats()
        for sh in self._shards:
            total.merge(sh.stats())
        total.dispatches = self._dispatches
        total.scalar_transfers = self._transfers
        return total

    def shard_stats(self) -> List[RunStats]:
        """Per-shard solo-comparable stats (each shard accounted as if it
        were its own DeviceMultiplexer wave)."""
        return [sh.stats() for sh in self._shards]

    def utilization_spread(self) -> float:
        """Max-min per-shard lane utilization: the load-imbalance signal."""
        utils = [s.utilization for s in self.shard_stats()
                 if s.lanes_launched > 0]
        if not utils:
            return 0.0
        return max(utils) - min(utils)

    @property
    def pending_jobs(self) -> int:
        return sum(len(q) for q in self._pending)

    @property
    def trace_count(self) -> int:
        return self._loop.trace_count
