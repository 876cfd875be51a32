"""Port parity: the per-node planner (``engine/autoscaler.py``
``plan_node_allocation``) and the runner's stage-affinity router
(``StreamingRunner._pick_worker``).

Every case of the reference's tests/engine/test_node_planner.py runs through
both packages on the same stages and node budgets, the reference's TPU
chips standing as the port's GPUs; the plans (per-stage totals, per-node
splits and preferred nodes) and the router's picks must be equal.
"""

from __future__ import annotations

import pytest

from cosmos_curate_tpu.core import stage as jstage
from cosmos_curate_tpu.engine import autoscaler as jauto
from cosmos_curate_tpu.engine.runner import StreamingRunner as JStreamingRunner
from cosmos_curate_tpu_torch.core import stage as tstage
from cosmos_curate_tpu_torch.engine import autoscaler as tauto
from cosmos_curate_tpu_torch.engine.runner import StreamingRunner as TStreamingRunner

DRIVER = ""  # the runner's convention: '' is the driver node


def _stage_cls(mod):
    class _Stage(mod.Stage):
        def __init__(self, name: str, resources, affinity: str | None = None) -> None:
            self._name = name
            self._resources = resources
            self._affinity = affinity

        @property
        def name(self) -> str:
            return self._name

        @property
        def resources(self):
            return self._resources

        @property
        def node_affinity(self) -> str | None:
            return self._affinity

        def process_data(self, tasks):
            return tasks

    return _Stage


_JStage, _TStage = _stage_cls(jstage), _stage_cls(tstage)


def _states(pkg: str, specs: list[dict]) -> list:
    out = []
    for s in specs:
        s = dict(s)
        name, cpus, dev = s.pop("name"), s.pop("cpus", 1.0), s.pop("dev", 0.0)
        rate, queued = s.pop("rate", None), s.pop("queued", 0)
        node_rates, affinity = s.pop("node_rates", {}), s.pop("affinity", None)
        if pkg == "jax":
            spec = jstage.StageSpec(stage=_JStage(name, jstage.Resources(cpus=cpus, tpus=dev), affinity), **s)
            out.append(jauto.StageScaleState(spec=spec, current_workers=1, throughput_per_worker=rate, queued=queued,
                                             node_rates=node_rates))
        else:
            spec = tstage.StageSpec(stage=_TStage(name, tstage.Resources(cpus=cpus, gpus=dev), affinity), **s)
            out.append(tauto.StageScaleState(spec=spec, throughput_per_worker=rate, queued=queued,
                                             node_rates=node_rates))
    return out


def _nodes(pkg: str, nodes: list[tuple]) -> list:
    if pkg == "jax":
        return [jauto.NodeBudget(n, cpus=c, tpu_chips=d) for n, c, d in nodes]
    return [tauto.NodeBudget(n, cpus=c, gpus=d) for n, c, d in nodes]


def _plan(pkg: str, specs: list[dict], nodes: list[tuple]) -> tuple:
    mod = jauto if pkg == "jax" else tauto
    p = mod.plan_node_allocation(_states(pkg, specs), _nodes(pkg, nodes))
    return p.targets, p.per_node, p.preferred_node


# the reference's single-node parity cases: (stages, cpus, chips)
SINGLE = {
    "rate-and-queue": ([dict(name="a", rate=10.0, queued=2), dict(name="b", rate=1.0, queued=9)], 8, 0),
    "zero-cost-io": ([dict(name="io", cpus=0.0, queued=100)], 4, 0),
    "device-stage": ([dict(name="dl", cpus=0.5, queued=5), dict(name="dec", rate=1.0, queued=9),
                      dict(name="emb", dev=1.0, rate=2.0)], 8, 4),
    "pinned-workers": ([dict(name="fixed", rate=0.1, queued=99, num_workers=2), dict(name="auto", rate=5.0)], 8, 0),
    "drained-vs-starved": ([dict(name="drained", rate=2.0, queued=0), dict(name="starved", rate=2.0, queued=50)],
                           6, 0),
}


@pytest.mark.parametrize("case", list(SINGLE), ids=list(SINGLE))
def test_single_node_plan_matches_jax_and_flat_plan(case):
    specs, cpus, dev = SINGLE[case]
    nodes = [(DRIVER, cpus, dev)]
    got, want = _plan("torch", specs, nodes), _plan("jax", specs, nodes)
    assert got == want
    targets, per_node, preferred = got
    # one node: the flat planner's totals, every worker on the only node
    assert targets == tauto.plan_allocation(_states("torch", specs), tauto.Budget(cpus=cpus, gpus=dev))
    assert per_node == [{DRIVER: t} for t in targets] and preferred == [DRIVER] * len(specs)


# the reference's heterogeneous-budget cases: (stages, nodes)
HETERO = {
    "device-pins-cpu-fans-out": ([dict(name="decode", cpus=1.0, rate=1.0, queued=30),
                                  dict(name="embed", dev=1.0, rate=4.0, queued=2)],
                                 [(DRIVER, 2, 4), ("cpu-node", 8, 0)]),
    "per-node-cpu-budgets": ([dict(name="work", cpus=2.0, rate=1.0, queued=100)],
                             [(DRIVER, 4, 0), ("small", 2, 0)]),
    "node-rate-bias": ([dict(name="decode", cpus=1.0, rate=1.0, queued=50, max_workers=3,
                             node_rates={"fast": 4.0, "slow": 0.5})],
                       [(DRIVER, 0.0, 0), ("fast", 3, 0), ("slow", 3, 0)]),
    "driver-affinity": ([dict(name="upload", cpus=1.0, rate=1.0, queued=10, affinity="driver"),
                         dict(name="decode", cpus=1.0, rate=1.0, queued=10)],
                        [(DRIVER, 2, 0), ("agent", 8, 0)]),
    "colocation": ([dict(name="a", cpus=1.0, rate=1.0, queued=4, min_workers=1, max_workers=1),
                    dict(name="b", cpus=1.0, rate=1.0, queued=4, min_workers=1, max_workers=1)],
                   [(DRIVER, 0.0, 0), ("n1", 4, 0), ("n2", 4, 0)]),
    "no-nodes": ([dict(name="only", rate=1.0, queued=1)], []),
    "unmeasured-late-joiner": ([dict(name="decode", cpus=1.0, rate=1.0, queued=40, max_workers=6,
                                     node_rates={"old": 2.0})],
                               [(DRIVER, 1, 0), ("old", 4, 0), ("new", 4, 0)]),
}


@pytest.mark.parametrize("case", list(HETERO), ids=list(HETERO))
def test_heterogeneous_plan_matches_jax(case):
    specs, nodes = HETERO[case]
    got = _plan("torch", specs, nodes)
    assert got == _plan("jax", specs, nodes)
    targets, per_node, preferred = got
    assert [sum(c.values()) for c in per_node] == targets
    if case == "device-pins-cpu-fans-out":
        assert set(per_node[1]) == {DRIVER} and preferred[0] == "cpu-node"
    if case == "driver-affinity":
        assert set(per_node[0]) == {DRIVER}
    if case == "node-rate-bias":
        assert per_node[0].get("fast", 0) > per_node[0].get("slow", 0)


def test_memory_fit_matches_jax():
    """Memory joins the fit only where the node declares capacity and the
    stage its demand."""
    plans = []
    for pkg, st_mod, auto in (("jax", jstage, jauto), ("torch", tstage, tauto)):
        cls = _JStage if pkg == "jax" else _TStage
        spec = st_mod.StageSpec(stage=cls("big", st_mod.Resources(cpus=1.0, memory_gb=6.0)), max_workers=4)
        kw = {} if pkg == "torch" else {"current_workers": 1}
        state = auto.StageScaleState(spec=spec, throughput_per_worker=1.0, queued=40, **kw)
        nodes = [auto.NodeBudget(DRIVER, cpus=0.0, memory_gb=0.0), auto.NodeBudget("lean", cpus=8, memory_gb=8.0),
                 auto.NodeBudget("fat", cpus=8, memory_gb=64.0)]
        p = auto.plan_node_allocation([state], nodes)
        plans.append((p.targets, p.per_node, p.preferred_node))
    assert plans[1] == plans[0]
    assert plans[1][1][0].get("fat", 0) > plans[1][1][0].get("lean", 0)


class _FakeAgent:
    def __init__(self, node_id: str) -> None:
        self.node_id = node_id


class _FakeProc:
    def __init__(self, node_id: str) -> None:
        if node_id:
            self._agent = _FakeAgent(node_id)


class _FakeWorker:
    def __init__(self, node_id: str) -> None:
        self.proc = _FakeProc(node_id)
        self.node = node_id


class _FakeRef:
    def __init__(self, name: str, size: int) -> None:
        self.shm_name = name
        self.total_size = size


class _FakeMgr:
    def __init__(self, owners: dict[str, str]) -> None:
        self._owners = owners

    def owner_node(self, ref) -> str:
        return self._owners.get(ref.shm_name, "")


# (idle worker nodes, owners, next stage's node, prefetched names)
ROUTES = {
    "input-locality-wins": (["n1", "n2"], {"x": "n2"}, "n1", ()),
    "next-stage-bonus-n2": (["n1", "n2"], {}, "n2", ()),
    "next-stage-bonus-n1": (["n1", "n2"], {}, "n1", ()),
    "prefetched-is-driver-local": (["", "n2"], {"x": "n2"}, None, ("x",)),
    "single-idle": (["n2"], {"x": "n1"}, "n1", ()),
}


@pytest.mark.parametrize("case", list(ROUTES), ids=list(ROUTES))
def test_router_picks_match_jax(case):
    nodes, owners, next_pref, prefetched = ROUTES[case]
    picks = []
    for cls in (JStreamingRunner, TStreamingRunner):
        r = cls()
        for name in prefetched:
            r._prefetched[name] = object()
        idle = [_FakeWorker(n) for n in nodes]
        picks.append(r._pick_worker(idle, [_FakeRef("x", 1000)], _FakeMgr(owners), next_pref=next_pref).node)
    assert picks[1] == picks[0]
