"""Quickstart on the PyTorch/CUDA port: the TREES epoch-synchronized
runtime in three scenes (``examples/quickstart.py`` on ``repro_torch``).

  1. A task-parallel program (fib) on the host-loop and resident device
     engines, with the paper's T1 / T-inf / overhead accounting.
  2. The paper's running example: postorder tree traversal (Fig. 2-4).
  3. Work-together graph analytics: BFS vs the hand-coded worklist baseline.

Runs on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import bfs, fib, treewalk
from repro_torch.apps.baselines import worklist
from repro_torch.core import DeviceEngine, HostEngine, compare, run_oracle

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# ---- 1. fib: fork/join/emit, host vs device engines ----------------------
n = 14
heap, values, host_stats = HostEngine(
    fib.PROGRAM, capacity=1 << 13, device=dev
).run(fib.initial(n))
print(f"fib({n}) = {int(values[0, 0])}  (expect {fib.fib_reference(n)})")
_, _, oracle_stats = run_oracle(fib.PROGRAM, fib.initial(n), capacity=1 << 13)
rep = compare(oracle_stats, host_stats)
print(
    f"  work T1={rep.t1_tasks} tasks, critical path T_inf={rep.t_inf_epochs} "
    f"epochs, parallelism={rep.parallelism:.1f}"
)
print(
    f"  host engine: {host_stats.dispatches} dispatches (V_inf), "
    f"lane utilization {rep.utilization:.2f} (V1 factor "
    f"{rep.v1_lane_factor:.2f})"
)
_, values_dev, dev_stats = DeviceEngine(
    fib.PROGRAM, capacity=1 << 13, stack_depth=256, device=dev
).run(fib.initial(n))
print(
    f"  device engine (whole loop resident on the device): same result "
    f"{int(values_dev[0, 0])}, dispatches={dev_stats.dispatches}"
)

# ---- 2. the paper's running example: postorder traversal -----------------
nn = 15
left, right = treewalk.random_tree(nn, seed=1)
prog = treewalk.make_program(nn, "post")
heap, _, st = HostEngine(prog, capacity=1 << 10, device=dev).run(
    treewalk.initial(), heap_init=dict(left=left, right=right)
)
ve = heap["visit_epoch"].cpu().numpy()
ok = all(
    ve[p] > ve[c]
    for p in range(nn)
    for c in (left[p], right[p])
    if c >= 0
)
print(f"\npostorder traversal of {nn}-node tree: parent-after-children = {ok}"
      f" ({st.epochs} epochs)")

# ---- 3. BFS: TREES program vs hand-coded worklist -------------------------
ng = 128
adj_off, adj = bfs.random_graph(ng, avg_degree=4, seed=3)
prog = bfs.make_program(ng, len(adj))
heap, _, st = HostEngine(prog, capacity=1 << 14, device=dev).run(
    bfs.initial(0), heap_init=bfs.heap_init(adj_off, adj, ng)
)
dist_trees = heap["dist"].cpu().numpy()
dist_wl, rounds = worklist.bfs_worklist(adj_off, adj, 0, ng, device=dev)
print(
    f"\nBFS on {ng} nodes: TREES == worklist baseline: "
    f"{np.array_equal(dist_trees, dist_wl.cpu().numpy())} "
    f"(TREES {st.epochs} epochs / worklist {rounds} rounds)"
)
if not (int(values[0, 0]) == int(values_dev[0, 0]) == fib.fib_reference(n)
        and ok and np.array_equal(dist_trees, dist_wl.cpu().numpy())):
    raise SystemExit("quickstart: a result differs from its reference")
print("quickstart OK")
