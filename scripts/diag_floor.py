"""Decompose the per-attempt cost of the lockstep loops with a device trace.

How much of the per-attempt cost is kernel-boundary / device-memory
round-trip (the slice a hand-fused whole-attempt kernel could recover) vs
irreducible on-device work?  Traces ONE north-star gradient step (the exact
__graft_entry__ build at B=10k), parses the perfetto trace, and prints:

  * device busy time vs wall span (gap share = dispatch/boundary slice)
  * kernel count and duration distribution
  * top-15 fusions by total device time

Run on the GPU:  python scripts/diag_floor.py [batch]
The trace is written under ``<checkout>/traces/floor``.
"""

import glob
import gzip
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import __graft_entry__ as ge

BATCH = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traces", "floor"
)

fn, (y0s, p_subs) = ge._build(
    batch=BATCH, tvals_n=21, rtol=1e-8, checkpoint_n=384
)
step = jax.jit(fn)

# compile + warm
out = jax.block_until_ready(step(y0s, p_subs))
t0 = time.perf_counter()
out = jax.block_until_ready(step(y0s, p_subs))
wall = time.perf_counter() - t0
print(f"one gradient step (B={BATCH}): {wall*1e3:.1f} ms wall")

shutil.rmtree(TRACE_DIR, ignore_errors=True)
with jax.profiler.trace(TRACE_DIR, create_perfetto_trace=True):
    out = jax.block_until_ready(step(y0s, p_subs))

paths = glob.glob(f"{TRACE_DIR}/**/*.trace.json.gz", recursive=True)
if not paths:
    print("no trace file produced (profiler unsupported on this backend?)")
    sys.exit(1)
with gzip.open(sorted(paths)[-1], "rt") as f:
    trace = json.load(f)

events = trace["traceEvents"]
# map pid/tid -> names to find device compute tracks
proc_names = {}
thread_names = {}
for e in events:
    if e.get("ph") == "M" and e.get("name") == "process_name":
        proc_names[e["pid"]] = e["args"]["name"]
    if e.get("ph") == "M" and e.get("name") == "thread_name":
        thread_names[(e["pid"], e.get("tid"))] = e["args"]["name"]

# GPU device tracks are named "/device:GPU:<i>" (one thread per stream)
device_pids = {pid for pid, name in proc_names.items() if "/device:GPU" in name}
slices = [
    e
    for e in events
    if e.get("ph") == "X"
    and e.get("pid") in device_pids
    and "dur" in e
    # keep compute streams; drop infeed/outfeed bookkeeping rows
    and "step" not in thread_names.get((e["pid"], e.get("tid")), "").lower()
]
if not slices:
    print("process names seen:", sorted(set(proc_names.values())))
    sys.exit("no device slices found")

durs = np.array([e["dur"] for e in slices], float)  # microseconds
starts = np.array([e["ts"] for e in slices], float)
ends = starts + durs
span = ends.max() - starts.min()
print(f"device slices: {len(slices)} | span {span/1e3:.2f} ms")

# ---- leaf-only analysis (the trace nests: jit > while > fusion) ---------
# a slice is a LEAF if no other slice on the same (pid, tid) starts inside
# it; containers (jit_*, while.*) wrap their body kernels
by_track = {}
for i, e in enumerate(slices):
    by_track.setdefault((e["pid"], e.get("tid")), []).append(i)
is_leaf = np.ones(len(slices), bool)
for idxs in by_track.values():
    idxs = sorted(idxs, key=lambda i: (starts[i], -durs[i]))
    stack = []
    for i in idxs:
        while stack and ends[stack[-1]] <= starts[i] + 1e-9:
            stack.pop()
        if stack:
            is_leaf[stack[-1]] = False
        stack.append(i)
leaf = np.nonzero(is_leaf)[0]
ldurs, lstarts, lends = durs[leaf], starts[leaf], ends[leaf]
print(
    f"leaf kernels: {len(leaf)} | leaf busy {ldurs.sum()/1e3:.2f} ms | "
    f"gap (span - leaf busy) {(span-ldurs.sum())/1e3:.2f} ms "
    f"({100*(span-ldurs.sum())/span:.1f}% of span)"
)
print(
    "leaf duration us: "
    f"mean {ldurs.mean():.2f} | p50 {np.percentile(ldurs,50):.2f} | "
    f"p90 {np.percentile(ldurs,90):.2f} | max {ldurs.max():.1f}"
)

# ---- per-loop decomposition: forward/backward while spans ---------------
loops = sorted(
    (i for i in range(len(slices)) if slices[i]["name"].startswith("while.")
     and durs[i] > 0.05 * span),
    key=lambda i: -durs[i],
)[:2]
for i in loops:
    inside = (lstarts >= starts[i]) & (lends <= ends[i])
    lb = ldurs[inside].sum()
    # iteration count: most-repeated kernel name inside this loop
    names_in = {}
    for j in leaf[np.nonzero(inside)[0]]:
        names_in[slices[j]["name"]] = names_in.get(slices[j]["name"], 0) + 1
    iters = max(names_in.values()) if names_in else 1
    print(
        f"\n{slices[i]['name']}: {durs[i]/1e3:.2f} ms, ~{iters} attempts -> "
        f"{durs[i]/iters:.1f} us/attempt | leaf busy {lb/1e3:.2f} ms "
        f"({100*lb/durs[i]:.1f}%) | boundary/gap {(durs[i]-lb)/1e3:.2f} ms "
        f"({100*(durs[i]-lb)/durs[i]:.1f}%) = {(durs[i]-lb)/iters:.1f} us/attempt"
    )
    agg = {}
    for j in leaf[np.nonzero(inside)[0]]:
        name = slices[j]["name"]
        d, c = agg.get(name, (0.0, 0))
        agg[name] = (d + slices[j]["dur"], c + 1)
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (d, c) in top:
        print(f"    {d/1e3:8.3f} ms  x{c:<5d} ({d/c:7.2f} us ea)  {name[:70]}")
