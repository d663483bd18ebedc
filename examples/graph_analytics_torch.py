"""Irregular-parallel graph analytics on the PyTorch/CUDA port of the TREES
runtime (paper §6.3; ``examples/graph_analytics.py`` on ``repro_torch``).

BFS and SSSP as fork/join task programs with chunked edge expansion, versus
the hand-coded Lonestar-style worklist baselines; validates both against
sequential references and reports the work-together accounting.  Runs on
the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/graph_analytics_torch.py [--nodes 256]
      [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.apps import bfs, sssp
from repro_torch.apps.baselines import worklist
from repro_torch.core import HostEngine

ap = argparse.ArgumentParser()
ap.add_argument("--nodes", type=int, default=256)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
n = args.nodes
dev = args.device


def _sync():
    # the engines and baselines return before the card has finished
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


adj_off, adj = bfs.random_graph(n, avg_degree=4, seed=0)
wgt = sssp.random_weights(len(adj), seed=1)
print(f"graph: {n} nodes, {len(adj)} edges")

# ---- BFS ------------------------------------------------------------------
t0 = time.time()
prog = bfs.make_program(n, len(adj))
heap, _, st = HostEngine(prog, capacity=1 << 16, device=dev).run(
    bfs.initial(0), heap_init=bfs.heap_init(adj_off, adj, n)
)
_sync()
t_trees = time.time() - t0
d_trees = heap["dist"].cpu().numpy()
t0 = time.time()
d_wl, rounds = worklist.bfs_worklist(adj_off, adj, 0, n, device=dev)
_sync()
t_wl = time.time() - t0
ref = bfs.bfs_reference(adj_off, adj, 0, n)
print(
    f"BFS   trees==ref: {np.array_equal(d_trees, ref)}  "
    f"worklist==ref: {np.array_equal(d_wl.cpu().numpy(), ref)}  "
    f"epochs={st.epochs} tasks={st.tasks_executed} "
    f"(trees {t_trees:.2f}s / worklist {t_wl:.2f}s)"
)

# ---- SSSP -----------------------------------------------------------------
t0 = time.time()
progs = sssp.make_program(n, len(adj))
heap, _, st = HostEngine(progs, capacity=1 << 17, device=dev).run(
    sssp.initial(0), heap_init=sssp.heap_init(adj_off, adj, wgt, n)
)
_sync()
t_trees = time.time() - t0
s_trees = heap["dist"].cpu().numpy()
t0 = time.time()
s_wl, rounds = worklist.sssp_worklist(adj_off, adj, wgt, 0, n, device=dev)
_sync()
t_wl = time.time() - t0
refs = sssp.sssp_reference(adj_off, adj, wgt, 0, n)
print(
    f"SSSP  trees~=ref: {np.allclose(s_trees, refs, rtol=1e-5)}  "
    f"worklist~=ref: {np.allclose(s_wl.cpu().numpy(), refs, rtol=1e-5)}  "
    f"epochs={st.epochs} tasks={st.tasks_executed} "
    f"(trees {t_trees:.2f}s / worklist {t_wl:.2f}s)"
)
if not (np.array_equal(d_trees, ref)
        and np.array_equal(d_wl.cpu().numpy(), ref)
        and np.allclose(s_trees, refs, rtol=1e-5)
        and np.allclose(s_wl.cpu().numpy(), refs, rtol=1e-5)):
    raise SystemExit("graph_analytics: a result differs from its reference")
