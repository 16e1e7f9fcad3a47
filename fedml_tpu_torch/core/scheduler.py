"""Client-workload schedulers (numpy; the port's copy of
``fedml_tpu/core/scheduler.py``: ``dp_schedule``:21, ``bucket_schedule``:79
and ``lane_schedule``:173, bit for bit).

- :func:`dp_schedule` — LPT greedy + local refinement of client workloads
  onto devices under memory caps (the reference's ``DP_schedule`` role).
- :func:`bucket_schedule` — the bucketed cohort schedule's width classes:
  an exact DP over the sorted batch counts, widths rounded up to powers of
  two, at most ``max_buckets`` classes.
- :func:`lane_schedule` — the packed cohort schedule's lanes: LPT over
  ``axis`` x powers of two lane counts, keeping the least padded work G*L
  (ties to the larger G).

Both cohort schedules are memoized on their arguments and hand out copies,
so a caller cannot corrupt the shared cache.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np


def dp_schedule(
    workloads: Sequence[float],
    constraints: Sequence[float],
    memory: Sequence[float],
) -> Tuple[List[List[int]], np.ndarray]:
    """Assign workload i (cost ``workloads[i] * constraints[device]``) to
    devices. Returns ``(assignment, device_costs)``; raises if a workload
    fits no device's ``memory``."""
    workloads = np.asarray(workloads, dtype=np.float64)
    constraints = np.asarray(constraints, dtype=np.float64)
    memory = np.asarray(memory, dtype=np.float64)
    n_dev = len(constraints)
    order = np.argsort(workloads)[::-1]  # longest processing time first
    assignment: List[List[int]] = [[] for _ in range(n_dev)]
    costs = np.zeros(n_dev)
    for i in order:
        cand_costs = costs + constraints * workloads[i]
        feasible = cand_costs <= memory
        if not feasible.any():
            raise ValueError(
                f"workload {int(i)} (cost {workloads[i]}) fits no device memory")
        cand = np.where(feasible, cand_costs, np.inf)
        d = int(np.argmin(cand))
        assignment[d].append(int(i))
        costs[d] = cand_costs[d]
    # local refinement: move a job off the busiest device if that lowers the makespan
    improved = True
    while improved:
        improved = False
        busiest = int(np.argmax(costs))
        for job in sorted(assignment[busiest], key=lambda j: workloads[j]):
            for d in np.argsort(costs):
                d = int(d)
                if d == busiest:
                    continue
                new_cost = costs[d] + constraints[d] * workloads[job]
                if new_cost < costs[busiest] and new_cost <= memory[d]:
                    assignment[busiest].remove(job)
                    assignment[d].append(job)
                    costs[busiest] -= constraints[busiest] * workloads[job]
                    costs[d] = new_cost
                    improved = True
                    break
            if improved:
                break
    return assignment, costs


def bucket_schedule(
    batch_counts: Sequence[int],
    axis: int,
    max_buckets: int = 4,
    max_width: int | None = None,
) -> List[Tuple[np.ndarray, int]]:
    """Group cohort positions into width buckets minimizing padded compute:
    a group costs its padded slot count (``ceil(k / axis)`` rounded up to a
    power of two, times ``axis``) times its width (the group's largest
    count rounded up to a power of two, capped at ``max_width``). Returns
    ``[(positions, width), ...]``, widths ascending."""
    cached = _bucket_schedule_cached(
        tuple(int(c) for c in batch_counts), int(axis), int(max_buckets),
        None if max_width is None else int(max_width))
    return [(pos.copy(), w) for pos, w in cached]


@functools.lru_cache(maxsize=64)
def _bucket_schedule_cached(
    batch_counts: Tuple[int, ...],
    axis: int,
    max_buckets: int,
    max_width: int | None,
) -> List[Tuple[np.ndarray, int]]:
    counts = np.asarray(batch_counts, dtype=np.int64)
    n = len(counts)
    axis = max(1, int(axis))
    if n == 0:
        return []
    order = np.argsort(counts, kind="stable")
    sc = 1 << np.ceil(np.log2(np.maximum(counts[order], 1))).astype(np.int64)
    if max_width is not None:
        sc = np.minimum(sc, int(max_width))

    B = max(1, min(int(max_buckets), n))
    # f[b][j] = least cost of the first j sorted clients in <= b groups,
    # minimized over the split point i in one vector op per j
    i_idx = np.arange(n)
    f_prev = np.full(n + 1, np.inf)
    f_prev[0] = 0.0
    back = np.zeros((B + 1, n + 1), dtype=np.int64)
    for b in range(1, B + 1):
        f_cur = np.full(n + 1, np.inf)
        f_cur[0] = 0.0
        for j in range(1, n + 1):
            k = j - i_idx[:j]
            per_axis = -(-k // axis)
            per_axis = (2 ** np.ceil(np.log2(np.maximum(per_axis, 1)))).astype(np.int64)
            cand = f_prev[:j] + per_axis * axis * int(sc[j - 1])
            arg = int(np.argmin(cand))
            f_cur[j] = cand[arg]
            back[b][j] = arg
        f_prev = f_cur
    cuts = []
    j, b = n, B
    while j > 0:
        i = int(back[b][j])
        cuts.append((i, j))
        j, b = i, b - 1
    cuts.reverse()
    return [(order[i:j].astype(np.int64), int(sc[j - 1])) for i, j in cuts if j > i]


def lane_schedule(
    batch_counts: Sequence[int],
    axis: int,
    max_lanes: int | None = None,
    force_lanes: int | None = None,
) -> Tuple[List[List[int]], int]:
    """Pack cohort positions into G balanced lanes for the packed executor.
    G runs over ``axis`` x powers of two up to ``max_lanes`` (or is
    ``force_lanes``, rounded to an axis multiple); clients go to lanes by
    LPT; the (G, L) of least padded work G*L wins, ties to the larger G.
    Returns ``(lanes, L)``: ``lanes[g]`` the ordered cohort positions of
    lane g, L the largest lane load in batches."""
    lanes, L = _lane_schedule_cached(
        tuple(int(c) for c in batch_counts), int(axis),
        None if max_lanes is None else int(max_lanes),
        None if force_lanes is None else int(force_lanes))
    return [list(lane) for lane in lanes], L


@functools.lru_cache(maxsize=64)
def _lane_schedule_cached(
    batch_counts: Tuple[int, ...],
    axis: int,
    max_lanes: int | None,
    force_lanes: int | None,
) -> Tuple[List[List[int]], int]:
    counts = np.asarray(batch_counts, dtype=np.int64)
    n = len(counts)
    axis = max(1, int(axis))
    cap = n if max_lanes is None else min(n, int(max_lanes))
    order = np.argsort(-counts, kind="stable")  # LPT: biggest first
    best = None
    candidates = []
    if force_lanes is not None:
        g = max(axis, -(-int(force_lanes) // axis) * axis)
        g = min(g, max(axis, (cap // axis) * axis))
        if g <= cap:
            candidates.append(g)
    else:
        g = axis
        while g <= cap:
            candidates.append(g)
            g *= 2
    for g in candidates:
        loads = np.zeros(g, dtype=np.int64)
        lanes: List[List[int]] = [[] for _ in range(g)]
        for pos in order:
            lane = int(np.argmin(loads))
            lanes[lane].append(int(pos))
            loads[lane] += counts[pos]
        L = int(loads.max())
        cost = g * L
        if best is None or cost <= best[0]:  # ties -> the larger g (checked last)
            best = (cost, lanes, L)
    if best is None:  # n < axis: one client per lane, lanes padded to axis
        lanes = [[int(p)] for p in order] + [[] for _ in range(axis - n)]
        return lanes, int(counts.max(initial=1))
    return best[1], best[2]
