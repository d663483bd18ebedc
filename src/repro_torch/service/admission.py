"""Admission layer of the serving front door (DESIGN.md §16), PyTorch
port of ``repro/service/admission.py`` — pure policy, the same code.

The service stack is three explicit layers:

1. **Admission** (this module): decides *which* queued jobs form the next
   wave and *when* a running wave should give a region back.  Pure policy —
   it never touches a TVM; it orders and packs :class:`JobHandle`\\ s under
   quota classes (priority, token-bucket rate limits, capacity shares) and
   plans preemptions for the wave scheduler to execute.
2. **Wave scheduler** (``multiplexer.py``): executes admission's plan at
   epoch boundaries — seats jobs through the ``_seed_region`` reseed
   path, lifts preempted regions into
   :class:`~repro_torch.service.jobs.RegionCheckpoint` images.
3. **Execution surface** (``api.py``): sync + async submit/poll/stream.

TREES makes this cheap by construction: the runtime already pays its
critical-path overhead "by the entire system at once" at explicit epoch
boundaries, so every chunk boundary is a natural yield point — admission
decisions piggyback on synchronization the runtime performs anyway,
where a work-first runtime would need fine-grained queues and locks.

Packing policy: stable sort by (priority desc, deadline asc, submission
order) — i.e. EDF within each priority band — then first-fit under the
capacity / max_jobs / value-dtype / class-share budgets, with per-class
token buckets gating how fast a class may consume wave slots.  With no
priorities, deadlines, or class limits configured this degenerates to
exactly the greedy FIFO first-fit the service shipped with, so the default
service behaves identically to before the refactor.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .jobs import AdmissionError, JobHandle, check_fleet_dtype

Clock = Callable[[], float]


@dataclasses.dataclass(frozen=True)
class QuotaClass:
    """One tenant class: the admission contract a job submits under.

    ``priority`` orders classes (higher runs first and may preempt lower);
    ``rate``/``burst`` form a token bucket (jobs admitted per second,
    bucket depth) so a chatty tenant class cannot starve the queue;
    ``share`` caps the fraction of one wave's slot capacity the class may
    hold at once; ``preemptible=False`` exempts the class's running jobs
    from eviction (they still yield regions when they finish).
    """

    name: str
    priority: int = 0
    rate: float = math.inf
    burst: float = math.inf
    share: float = 1.0
    preemptible: bool = True


DEFAULT_CLASS = QuotaClass(name="default")


class AdmissionController:
    """Wave assembly + preemption planning over quota classes.

    Owns no execution state: the service hands it the queue and the
    running set; it hands back ordered picks and victim lists.  The clock
    is injectable (virtual time in the load generator, ``time.monotonic``
    in production) and must be the same clock the handles were stamped
    with — deadline arithmetic mixes the two otherwise.
    """

    def __init__(
        self,
        classes: Optional[Sequence[QuotaClass]] = None,
        clock: Clock = time.monotonic,
        evict_over_deadline: bool = False,
    ):
        self.clock = clock
        self.evict_over_deadline = bool(evict_over_deadline)
        self.classes: Dict[str, QuotaClass] = {"default": DEFAULT_CLASS}
        for qc in classes or ():
            self.classes[qc.name] = qc
        # token buckets: class name -> [tokens, last refill timestamp]
        self._buckets: Dict[str, List[float]] = {}
        # per-class outcome counters (the deadline-miss ratio numerators)
        self.deadline_misses: Dict[str, int] = {}
        self.deadline_met: Dict[str, int] = {}
        self.preempted: Dict[str, int] = {}

    # ------------------------------------------------------------ classes
    def klass_of(self, h: JobHandle) -> QuotaClass:
        qc = self.classes.get(h.klass)
        if qc is None:
            raise AdmissionError(
                f"job {h.job.name!r}: unknown quota class {h.klass!r} "
                f"(known: {sorted(self.classes)})"
            )
        return qc

    def effective_priority(self, h: JobHandle) -> int:
        """Job priority overrides its class's when explicitly set."""
        return h.priority if h.priority else self.klass_of(h).priority

    # ------------------------------------------------------ token buckets
    def _refill(self, qc: QuotaClass, now: float) -> List[float]:
        b = self._buckets.get(qc.name)
        if b is None:
            b = [min(qc.burst, max(1.0, qc.burst)), now]
            if math.isinf(qc.rate):
                b[0] = math.inf
            self._buckets[qc.name] = b
            return b
        if not math.isinf(qc.rate):
            b[0] = min(qc.burst, b[0] + (now - b[1]) * qc.rate)
        b[1] = now
        return b

    def allow(self, h: JobHandle, now: Optional[float] = None) -> bool:
        """Consume one admission token for this job's class (always true
        for unlimited classes).  Called once per actual seating — both by
        wave assembly and by the streaming mid-flight admit path, so rate
        limits hold across both doors."""
        qc = self.klass_of(h)
        if math.isinf(qc.rate):
            return True
        b = self._refill(qc, self.clock() if now is None else now)
        if b[0] >= 1.0:
            b[0] -= 1.0
            return True
        return False

    def has_token(self, h: JobHandle, now: Optional[float] = None) -> bool:
        """Non-consuming :meth:`allow`: whether the class *could* admit
        now.  The streaming admit path checks this first so a job with no
        free region doesn't burn a token on the failed attempt."""
        qc = self.klass_of(h)
        if math.isinf(qc.rate):
            return True
        b = self._refill(qc, self.clock() if now is None else now)
        return b[0] >= 1.0

    # ------------------------------------------------------ wave assembly
    def order(self, queue: Sequence[JobHandle]) -> List[JobHandle]:
        """Admission order: priority desc, then EDF, then submission order
        (the sort is stable and job_ids are monotone, so FIFO survives as
        the tie-break and the whole thing degenerates to FIFO when nobody
        sets priorities or deadlines)."""
        return sorted(
            queue,
            key=lambda h: (
                -self.effective_priority(h),
                h.deadline if h.deadline is not None else math.inf,
                h.job_id,
            ),
        )

    def take_wave(
        self,
        queue: List[JobHandle],
        capacity: int,
        max_jobs: int,
        now: Optional[float] = None,
    ) -> Tuple[List[JobHandle], List[JobHandle]]:
        """Assemble the next wave: (picked, left-behind).

        First-fit in admission order under four budgets: wave capacity,
        ``max_jobs`` fan-in, one TV value dtype per wave, and each class's
        ``share`` of capacity; the class token bucket is consumed per
        pick.  Left-behind jobs keep their queue positions for the next
        assembly — nothing is dropped here (rate-limited jobs simply wait
        for tokens)."""
        now = self.clock() if now is None else now
        wave: List[JobHandle] = []
        left: List[JobHandle] = []
        budget = capacity
        class_used: Dict[str, int] = {}
        for h in self.order(queue):
            qc = self.klass_of(h)
            cap_share = int(qc.share * capacity)
            if (
                len(wave) < max_jobs
                and h.job.quota <= budget
                and class_used.get(qc.name, 0) + h.job.quota <= cap_share
            ):
                try:
                    check_fleet_dtype(
                        [w.job.program for w in wave] + [h.job.program]
                    )
                except AdmissionError:
                    left.append(h)
                    continue
                if not self.allow(h, now):
                    left.append(h)
                    continue
                wave.append(h)
                budget -= h.job.quota
                class_used[qc.name] = (
                    class_used.get(qc.name, 0) + h.job.quota
                )
            else:
                left.append(h)
        # left-behind keeps submission order (stable under re-sorts)
        left.sort(key=lambda h: h.job_id)
        return wave, left

    # -------------------------------------------------------- preemption
    def plan_preemptions(
        self,
        running: Sequence[JobHandle],
        queued: Sequence[JobHandle],
        now: Optional[float] = None,
    ) -> List[JobHandle]:
        """Pick running victims to make room for starved queued jobs.

        A queued job may displace running work only when its priority is
        *strictly* higher than the victim's (strictness prevents equal
        -priority ping-pong: a resumed job can never be re-evicted by the
        peer it displaced).  Victims are preemptible, chosen lowest
        priority first (FIFO-late among equals), and only until the freed
        quota covers the demander.  With ``evict_over_deadline`` the
        controller additionally evicts preemptible running jobs already
        past their deadline when anything at all is queued — the region is
        worth more to a job that can still meet its contract.
        """
        now = self.clock() if now is None else now
        victims: List[JobHandle] = []
        pool = [
            h for h in running
            if self.klass_of(h).preemptible and not h.done
        ]
        # lowest priority last-submitted first: cheapest progress lost
        pool.sort(
            key=lambda h: (self.effective_priority(h), -h.job_id)
        )
        if self.evict_over_deadline and queued:
            for h in list(pool):
                if h.deadline is not None and now > h.deadline:
                    victims.append(h)
                    pool.remove(h)
        for q in self.order(queued):
            qp = self.effective_priority(q)
            need = q.job.quota
            freed = sum(v.job.quota for v in victims)
            if freed >= need:
                continue
            for v in list(pool):
                if self.effective_priority(v) >= qp:
                    break  # pool is priority-ascending: no victim fits
                victims.append(v)
                pool.remove(v)
                freed += v.job.quota
                if freed >= need:
                    break
        return victims

    # ------------------------------------------------------- accounting
    def note_finished(
        self, h: JobHandle, now: Optional[float] = None
    ) -> Optional[bool]:
        """Record the deadline outcome of a finished job (None if the job
        had no deadline; True = met).  Feeds the per-class deadline-miss
        ratio the metrics layer exports."""
        if h.deadline is None:
            return None
        now = self.clock() if now is None else now
        end = h.finished_at if h.finished_at is not None else now
        met = end <= h.deadline
        key = h.klass
        if met:
            self.deadline_met[key] = self.deadline_met.get(key, 0) + 1
        else:
            self.deadline_misses[key] = (
                self.deadline_misses.get(key, 0) + 1
            )
        return met

    def note_preempted(self, h: JobHandle) -> None:
        self.preempted[h.klass] = self.preempted.get(h.klass, 0) + 1

    def miss_ratio(self, klass: Optional[str] = None) -> float:
        """Deadline-miss ratio, per class or overall (0.0 when no
        deadlined job has finished yet)."""
        if klass is None:
            miss = sum(self.deadline_misses.values())
            met = sum(self.deadline_met.values())
        else:
            miss = self.deadline_misses.get(klass, 0)
            met = self.deadline_met.get(klass, 0)
        total = miss + met
        return miss / total if total else 0.0

    def deadline_slack(
        self,
        queued: Sequence[JobHandle],
        running: Sequence[JobHandle] = (),
        now: Optional[float] = None,
    ) -> float:
        """Seconds until the nearest outstanding deadline (inf if none).

        The chunk controller folds this in: a tightening nearest deadline
        shrinks K so completions (and preemption yield points) surface
        sooner than the hot-queue heuristic alone would arrange."""
        now = self.clock() if now is None else now
        slack = math.inf
        for h in list(queued) + list(running):
            if h.deadline is not None and not h.done:
                slack = min(slack, h.deadline - now)
        return slack
