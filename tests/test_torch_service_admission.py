"""Port parity: admission (``service/admission.py``), the scenarios of
``tests/service/test_admission.py`` run through both packages.

Each scenario drives the JAX package's ``AdmissionController`` and the
port's with records of the same tenants and lanes, and must give the same
decisions (admitted, reason, Retry-After), the same dispatch order and the
same capacity clamps; the reference's own assertions hold on the port.
"""

from __future__ import annotations

import dataclasses

import pytest

from tests.fixtures.service_harness import PACKAGES, package

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS


def _budget(pkg, cpus=8.0, memory_gb=0.0):
    mod = __import__(f"{pkg.name}.engine.autoscaler", fromlist=["NodeBudget"])
    return mod.NodeBudget("", cpus=cpus, memory_gb=memory_gb)


def _ctrl(pkg, budget_cpus=8.0, memory_gb=0.0, **cfg_kw):
    return pkg.admission.AdmissionController(pkg.admission.QuotaConfig(**cfg_kw),
                                             budget=_budget(pkg, budget_cpus, memory_gb))


def _rec(pkg, tenant="t", priority="batch"):
    return pkg.job_queue.JobRecord.new("split", {}, tenant=tenant, priority=priority)


def _decision(d) -> tuple:
    return (d.admitted, d.reason, d.retry_after_s)


def both(scenario) -> list:
    """``scenario(pkg)`` on each package; the two transcripts must agree."""
    outs = [scenario(pkg) for pkg in PKGS]
    assert outs[1] == outs[0]
    return outs[1]


def test_quota_config_is_the_reference_config():
    port = [(f.name, f.default) for f in dataclasses.fields(PORT.admission.QuotaConfig)]
    assert port == [(f.name, f.default) for f in dataclasses.fields(JAX.admission.QuotaConfig)]


class TestQuotas:
    def test_admit_then_shed_per_tenant(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_queued_per_tenant=2)
            return [_decision(ctrl.admit(_rec(pkg))) for _ in range(3)]

        out = both(scenario)
        assert out[0][0] and out[1][0]
        assert not out[2][0] and out[2][1] == "tenant_queue_full" and out[2][2] > 0

    def test_tenant_quota_is_isolated(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_queued_per_tenant=1)
            return [ctrl.admit(_rec(pkg, tenant=t)).admitted for t in ("a", "a", "b")]

        assert both(scenario) == [True, False, True]

    def test_global_queue_cap(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_queued_total=2, max_queued_per_tenant=10)
            return [_decision(ctrl.admit(_rec(pkg, tenant=t))) for t in ("a", "b", "c")]

        out = both(scenario)
        assert [d[0] for d in out] == [True, True, False] and out[2][1] == "queue_full"

    def test_unknown_lane_rejected_without_retry(self):
        out = both(lambda pkg: _decision(_ctrl(pkg).admit(_rec(pkg, priority="bulk"))))
        assert not out[0] and out[2] == 0

    def test_requeue_bypasses_quota(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_queued_per_tenant=1)
            ctrl.admit(_rec(pkg))
            ctrl.requeue(_rec(pkg))
            return ctrl.queued_total()

        assert both(scenario) == 2

    def test_distinct_tenant_cap(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_tenants=2)
            return [_decision(ctrl.admit(_rec(pkg, tenant=t)))[:2] for t in ("a", "b", "c", "a")]

        assert both(scenario) == [(True, ""), (True, ""), (False, "tenant_limit"), (True, "")]

    def test_retry_after_scales_with_backlog(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_queued_per_tenant=100, max_queued_total=3, max_concurrent_jobs=1)
            ctrl.admit(_rec(pkg))
            shallow = ctrl._retry_after()
            ctrl.admit(_rec(pkg))
            ctrl.admit(_rec(pkg))
            return shallow, ctrl._retry_after()

        shallow, deep = both(scenario)
        assert deep > shallow


class TestDispatchOrder:
    def test_interactive_lane_first(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg)
            b, i = _rec(pkg, priority="batch"), _rec(pkg, priority="interactive")
            ctrl.admit(b)
            ctrl.admit(i)
            return [ctrl.pop_next([]).priority, ctrl.pop_next([]).priority]

        assert both(scenario) == ["interactive", "batch"]

    def test_round_robin_across_tenants(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_running_per_tenant=10, max_concurrent_jobs=4)
            for t in ("a", "a", "b"):
                ctrl.admit(_rec(pkg, tenant=t))
            first = ctrl.pop_next([])
            second = ctrl.pop_next([first])
            third = ctrl.pop_next([first, second])
            return [first.tenant, second.tenant, third.tenant]

        out = both(scenario)
        assert set(out[:2]) == {"a", "b"} and out[2] == "a"

    def test_fifo_within_tenant(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg)
            r1, r2 = _rec(pkg), _rec(pkg)
            ctrl.admit(r1)
            ctrl.admit(r2)
            return [ctrl.pop_next([]) is r1, ctrl.pop_next([r1]) is r2]

        assert both(scenario) == [True, True]

    def test_tenant_running_cap_skipped(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_running_per_tenant=1, max_concurrent_jobs=4)
            a2, b1 = _rec(pkg, tenant="a"), _rec(pkg, tenant="b")
            ctrl.admit(a2)
            ctrl.admit(b1)
            running_a = _rec(pkg, tenant="a")
            running_a.state = "running"
            first = ctrl.pop_next([running_a])
            return [first is b1, ctrl.pop_next([running_a, b1])]

        assert both(scenario) == [True, None]

    def test_empty_returns_none(self):
        assert both(lambda pkg: _ctrl(pkg).pop_next([])) is None


class TestCapacity:
    def test_global_concurrency_cap(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg, max_concurrent_jobs=1, max_running_per_tenant=5)
            ctrl.admit(_rec(pkg))
            running = _rec(pkg)
            running.state = "running"
            return ctrl.pop_next([running])

        assert both(scenario) is None

    @pytest.mark.parametrize("quota,cpus,memory_gb,want", [
        ({"max_concurrent_jobs": 8, "cpus_per_job": 1.0}, 2.0, 0.0, 2),
        ({"max_concurrent_jobs": 8, "cpus_per_job": 0.0, "memory_gb_per_job": 4.0}, 1.0, 10.0, 2),
        ({"cpus_per_job": 1.0}, 0.5, 0.0, 1),
        ({"max_concurrent_jobs": 4, "cpus_per_job": 0.0}, 1.0, 0.0, 4),
    ], ids=["host-cpu-clamp", "memory-clamp", "tiny-host-still-runs-one", "zero-cost-disables-clamp"])
    def test_effective_max_running(self, quota, cpus, memory_gb, want):
        assert both(lambda pkg: _ctrl(pkg, cpus, memory_gb, **quota).effective_max_running()) == want

    def test_host_budget_is_this_host(self):
        port, ref = PORT.admission.host_budget(), JAX.admission.host_budget()
        assert (port.node_id, port.cpus, port.memory_gb) == (ref.node_id, ref.cpus, ref.memory_gb)


class TestRemove:
    def test_remove_queued(self):
        def scenario(pkg):
            ctrl = _ctrl(pkg)
            r = _rec(pkg)
            ctrl.admit(r)
            return [ctrl.remove(r.job_id) is r, ctrl.queued_total(), ctrl.remove(r.job_id)]

        assert both(scenario) == [True, 0, None]
