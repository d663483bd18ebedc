"""Work / critical-path accounting in the paper's analytical framework
(PyTorch port of ``repro/core/analysis.py``).

Paper §1/§2.2/§4.4:  T_P = V1 * T1 / P + V_inf * T_inf.
The oracle gives the ideal T1 (tasks) and T_inf (epochs); engine stats give
the realized work (lanes launched, incl. padding = SIMT-divergence analogue)
and the realized critical path (dispatches + scalar transfers).  This module
derives the overhead factors so benchmarks can report V1 / V_inf directly,
and exposes the greedy-schedule bound used throughout the paper.
"""
from __future__ import annotations

import dataclasses

from .interp import OracleStats
from .scheduler import RunStats


@dataclasses.dataclass(frozen=True)
class OverheadReport:
    t1_tasks: int            # ideal work
    t_inf_epochs: int        # ideal critical path
    parallelism: float       # T1 / T_inf
    v1_lane_factor: float    # lanes launched / ideal tasks  (work overhead)
    v_inf_dispatches: int    # host->device launches on the critical path
    v_inf_transfers: int     # device->host readbacks on the critical path
    utilization: float       # active / launched lanes

    def greedy_bound(self, p: int) -> float:
        """Greedy offline schedule bound  T_P = O(T1/P) + O(T_inf)  [Brent]."""
        return self.t1_tasks / p + self.t_inf_epochs


def compare(oracle: OracleStats, engine: RunStats) -> OverheadReport:
    """Relate engine-realized cost to the oracle's ideal T1 / T_inf."""
    if engine.tasks_executed and engine.tasks_executed != oracle.tasks_executed:
        raise ValueError(
            "engine executed a different task count than the oracle: "
            f"{engine.tasks_executed} vs {oracle.tasks_executed}"
        )
    t1 = oracle.tasks_executed
    tinf = oracle.epochs
    return OverheadReport(
        t1_tasks=t1,
        t_inf_epochs=tinf,
        parallelism=t1 / max(1, tinf),
        v1_lane_factor=engine.lanes_launched / max(1, t1),
        v_inf_dispatches=engine.dispatches,
        v_inf_transfers=engine.scalar_transfers,
        utilization=engine.utilization,
    )
