"""Throughput-based worker planner (port of
``cosmos_curate_tpu/engine/autoscaler.py``: ``StageScaleState``, ``Budget``
and ``plan_allocation``).

Measure per-worker throughput per stage, then solve for the worker
allocation that maximises *balanced* pipeline throughput under the CPU/GPU
budget. Solver: water-filling. The pipeline rate is the min over stages of
(workers_i x rate_i); grant a worker to the stage with the lowest projected
stage rate, again and again, until the budget is spent. Stages without
throughput samples yet get their minimum and first claim on resources.

Backpressure: the observed input-queue depth *biases* the fill (between
stages with similar projected rates, the deeper backlog wins), and a
drained stage (empty queue, known rate) gets no worker beyond its minimum,
so budget flows to starved stages after a throughput shift.

In GPU terms: ``Resources.gpus`` costs its share of the GPU budget and
``entire_gpu_host`` costs the whole budget, as the reference's ``tpus`` and
``entire_tpu_host`` do. A GPU stage gets one worker. As in the reference,
every stage's first worker is granted unconditionally, its GPU cost
included; so once the GPU stages' first grants overrun the card count, no
other grant fits the GPU budget, not even a CPU stage's zero GPU cost, and
no stage fans out.

Not ported: the per-node placement (``plan_node_allocation``,
``NodeBudget``, ``StageScaleState.node_rates``), which waits for multi-node
runs (ROADMAP queue A item 15), and ``StageScaleState.current_workers``,
which the planner does not read.
"""

from __future__ import annotations

from dataclasses import dataclass

from cosmos_curate_tpu_torch.core.stage import StageSpec


@dataclass
class StageScaleState:
    spec: StageSpec
    throughput_per_worker: float | None  # batches/s; None = unknown yet
    queued: int


@dataclass(frozen=True)
class Budget:
    cpus: float
    gpus: float


def plan_allocation(stages: list[StageScaleState], budget: Budget) -> list[int]:
    """Target worker counts per stage (same order as input)."""
    n = len(stages)
    alloc = [0] * n
    cpu_left = budget.cpus
    gpu_left = budget.gpus

    def cost(i: int) -> tuple[float, float]:
        r = stages[i].spec.stage.resources
        gpus = r.gpus if not r.entire_gpu_host else budget.gpus
        cpus = r.cpus
        if cpus <= 0 and gpus <= 0:
            # a declared zero-cost stage (pure IO) must still consume
            # budget, or the water-fill below never ends (fits() forever true)
            cpus = 0.25
        return (cpus, gpus)

    def fits(i: int) -> bool:
        c, g = cost(i)
        return c <= cpu_left + 1e-9 and g <= gpu_left + 1e-9

    def grant(i: int) -> None:
        nonlocal cpu_left, gpu_left
        c, g = cost(i)
        alloc[i] += 1
        cpu_left -= c
        gpu_left -= g

    # 1. minimum viable allocation: every stage gets >= min_workers (>= 1)
    #    even if that oversubscribes the host (a pipeline where some stage
    #    has no worker can never finish); only additional workers respect
    #    the budget
    for i, st in enumerate(stages):
        want = max(1, st.spec.min_workers)
        if st.spec.num_workers is not None:
            want = st.spec.num_workers
        if st.spec.stage.resources.uses_gpu:
            want = 1  # one in-process worker per GPU stage
        grant(i)  # unconditional first worker
        for _ in range(want - 1):
            if fits(i):
                grant(i)

    # 2. water-fill the bottleneck with the remaining budget
    while True:
        best = None
        best_score = None
        for i, st in enumerate(stages):
            if st.spec.num_workers is not None:  # fixed-size pool
                continue
            cap = st.spec.max_workers
            if cap is not None and alloc[i] >= cap:
                continue
            if not fits(i):
                continue
            # GPU stages don't scale by worker count
            if st.spec.stage.resources.uses_gpu and alloc[i] >= 1:
                continue
            rate = st.throughput_per_worker
            if rate is not None and st.queued == 0 and alloc[i] >= max(1, st.spec.min_workers):
                # drained and measured: no backlog to spend extra workers
                # on; leave the budget for starved stages (the runner stops
                # the now-surplus idle workers)
                continue
            projected = (rate if rate is not None else 1.0) * alloc[i]
            # queue bias: between similar projected rates, the deeper
            # backlog wins; the dimensionless damping keeps rate primary
            score = projected / (1.0 + float(st.queued))
            if best_score is None or score < best_score:
                best_score = score
                best = i
        if best is None:
            break
        grant(best)
    return alloc
