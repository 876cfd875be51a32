"""Throughput-based worker planner (port of
``cosmos_curate_tpu/engine/autoscaler.py``: ``plan_allocation`` and the
per-node ``plan_node_allocation``).

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

Cross-host: ``plan_node_allocation`` lifts the same water-fill to
**per-node budgets** (one ``NodeBudget`` per connected agent plus the
driver). The per-stage totals come from the flat solver over the aggregate
budget, so a one-node plan is ``plan_allocation``'s exactly; a placement
pass then pins device stages to GPU-bearing nodes, honours
``Stage.node_affinity``, and fans CPU workers across nodes weighted by each
node's measured per-worker rate for that stage, with a bias toward the
previous stage's node so inter-stage bytes stay on one node.

Not ported: ``StageScaleState.current_workers``, which no planner reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.core.stage import StageSpec


@dataclass
class StageScaleState:
    spec: StageSpec
    throughput_per_worker: float | None  # batches/s; None = unknown yet
    queued: int
    # node id -> measured per-worker batches/s ON that node; empty on a
    # single-node run or before per-node samples land
    node_rates: dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class Budget:
    cpus: float
    gpus: float


@dataclass(frozen=True)
class NodeBudget:
    """One schedulable host: the driver (``node_id=""``, the runner's
    worker-node convention) or a connected agent (engine/remote_agent.py)."""

    node_id: str
    cpus: float
    gpus: int = 0
    memory_gb: float = 0.0


@dataclass
class NodeAllocation:
    """``plan_node_allocation``'s output. ``targets[i]`` is stage i's total
    worker count (``plan_allocation``'s over the aggregate budget);
    ``per_node[i]`` splits it across nodes; ``preferred_node[i]`` is the node
    holding the plurality of stage i's workers, the router's affinity key
    (stage k's outputs should land where stage k+1's workers live)."""

    targets: list[int]
    per_node: list[dict[str, int]]
    preferred_node: list[str]


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


def plan_node_allocation(stages: list[StageScaleState], nodes: list[NodeBudget]) -> NodeAllocation:
    """Per-node x per-stage worker allocation. Totals come from
    ``plan_allocation`` over the aggregate budget; placement then assigns
    each worker to a node:

    - GPU stages go to GPU-bearing nodes only (in this engine, the driver:
      the cards belong to the engine process, engine/pool.py);
    - ``Stage.node_affinity == "driver"`` pins a stage to the driver;
    - CPU stages water-fill across nodes: each grant goes to the fitting
      node with the best (measured stage rate, co-location with the
      previous stage's node, free CPUs) score.
    """
    if not nodes:
        nodes = [NodeBudget("", cpus=1.0)]
    budget = Budget(cpus=sum(n.cpus for n in nodes), gpus=float(sum(n.gpus for n in nodes)))
    targets = plan_allocation(stages, budget)
    cpu_left = {n.node_id: n.cpus for n in nodes}
    gpus_left = {n.node_id: float(n.gpus) for n in nodes}
    # memory joins the CPU fit only where BOTH the node declares capacity
    # and the stage declares demand (0 = unknown: fit on CPUs alone)
    mem_left = {n.node_id: n.memory_gb for n in nodes}
    driver_id = nodes[0].node_id  # the runner's convention: nodes[0] is the driver
    per_node: list[dict[str, int]] = []
    preferred: list[str] = []
    prev_pref = driver_id
    order = {n.node_id: j for j, n in enumerate(nodes)}
    for st, want in zip(stages, targets):
        res = st.spec.stage.resources
        affinity = getattr(st.spec.stage, "node_affinity", None)
        counts: dict[str, int] = {}
        for _ in range(want):
            if affinity == "driver":
                chosen = driver_id
            elif res.uses_gpu:
                # with no GPU-bearing node visible the driver hosts the
                # in-process worker, as the flat path does
                cands = [n.node_id for n in nodes if n.gpus > 0] or [driver_id]
                chosen = max(cands, key=lambda nid: gpus_left[nid])
                gpus_left[chosen] -= res.gpus if not res.entire_gpu_host else gpus_left[chosen]
            else:
                ccost = res.cpus if res.cpus > 0 else 0.25
                chosen = _best_cpu_node(st, nodes, cpu_left, ccost, prev_pref, mem_left=mem_left,
                                        mem_cost=res.memory_gb)
            counts[chosen] = counts.get(chosen, 0) + 1
            cpu_left[chosen] -= res.cpus if res.cpus > 0 else 0.25
            mem_left[chosen] -= res.memory_gb
        per_node.append(counts)
        # plurality node; ties break by node order, so the router's key is
        # stable across replans with equal splits
        pref = max(counts, key=lambda nid: (counts[nid], -order.get(nid, 0))) if counts else prev_pref
        preferred.append(pref)
        prev_pref = pref
    return NodeAllocation(targets=targets, per_node=per_node, preferred_node=preferred)


def _best_cpu_node(st: StageScaleState, nodes: list[NodeBudget], cpu_left: dict[str, float], ccost: float,
                   prev_pref: str, *, mem_left: dict[str, float] | None = None, mem_cost: float = 0.0) -> str:
    """One CPU-worker grant: fitting nodes first, then the measured
    per-worker rate on that node, then co-location with the upstream
    stage's node, then free CPUs. A node without samples ranks at the mean
    measured rate (neutral exploration). Nothing fits: the least
    oversubscribed node, mirroring the flat planner's unconditional first
    grant."""
    measured = [r for r in st.node_rates.values() if r > 0]
    neutral = sum(measured) / len(measured) if measured else 1.0

    def key(n: NodeBudget):
        fits = cpu_left[n.node_id] + 1e-9 >= ccost
        if fits and mem_cost > 0 and n.memory_gb > 0 and mem_left is not None:
            fits = mem_left[n.node_id] + 1e-9 >= mem_cost
        rate = st.node_rates.get(n.node_id)
        return (fits, rate if rate is not None else neutral, 1 if n.node_id == prev_pref else 0, cpu_left[n.node_id])

    return max(nodes, key=key).node_id
