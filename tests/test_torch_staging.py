"""The port's transfer engine (repro_torch/core/staging.py) against the reference.

On an idle link the port charges a cold read exactly what the reference
charges.  Where the link is busy the port also charges the backlog queued on
it, so a read picks the replica whose link frees first and a binding policy
sees how deep a site's inbound queue is; the reference charges the idle
link's time whatever the queue.  Everything runs on a manual virtual clock,
so every time below is exact.
"""
from __future__ import annotations

import pytest

from repro.core.staging import DatasetRegistry as JDatasetRegistry
from repro.core.staging import TransferEngine as JTransferEngine
from repro.runtime.clock import virtual_time as jvirtual_time
from repro_torch.core.staging import SHARED_SITE, DatasetRegistry, TransferEngine
from repro_torch.runtime.clock import virtual_time

SITES = (("a", "cloud"), ("b", "hpc"))


def _engine(registry_cls, engine_cls, seed: int = 0):
    reg = registry_cls()
    for name, platform in SITES:
        reg.register_site(name, platform=platform)
    return reg, engine_cls(reg, seed=seed)


@pytest.mark.parametrize("size_mb", [1.0, 512.0, 2048.0])
@pytest.mark.parametrize("holders", [(SHARED_SITE,), ("a",), (SHARED_SITE, "a"), ("b",)])
def test_an_idle_link_costs_what_the_reference_charges(size_mb, holders):
    costs = []
    for registry_cls, engine_cls, clock in (
        (JDatasetRegistry, JTransferEngine, jvirtual_time),
        (DatasetRegistry, TransferEngine, virtual_time),
    ):
        with clock(auto_advance=False):
            reg, eng = _engine(registry_cls, engine_cls)
            reg.add("ds", size_mb, sites=holders)
            costs.append([eng.expected_transfer_s("ds", dst) for dst in ("a", "b", SHARED_SITE)])
    assert costs[0] == costs[1]


def test_the_backlog_on_a_link_is_charged_and_steers_the_source():
    with virtual_time(auto_advance=False) as clock:
        reg, eng = _engine(DatasetRegistry, TransferEngine)
        shared_hpc, cloud_hpc = eng.link_model(SHARED_SITE, "b"), eng.link_model("a", "b")
        done = []
        for i in range(4):  # 2 active + 2 queued on shared -> b
            reg.add(f"in{i}", 600.0, sites=(SHARED_SITE,))
            eng.fetch(f"in{i}", "b", done.append)
        assert eng.active_transfers() == 2 and eng.queued_transfers() == 2
        active = [tr for tr in eng._active[(SHARED_SITE, "b")]]
        want = (sum(tr.eta for tr in active) + 2 * shared_hpc.expected_s(600.0)) / eng.max_per_link
        assert eng.wait_s(SHARED_SITE, "b") == pytest.approx(want, rel=1e-12)
        assert eng.wait_s("a", "b") == 0.0

        # a replica on both sides: the idle cloud -> hpc link is slower per
        # byte but frees first, so it is the cost and the source
        reg.add("both", 600.0, sites=(SHARED_SITE, "a"))
        idle = cloud_hpc.expected_s(600.0)
        assert idle > shared_hpc.expected_s(600.0)
        assert eng.wait_s(SHARED_SITE, "b") + shared_hpc.expected_s(600.0) > idle
        assert eng.expected_transfer_s("both", "b") == idle
        eng.fetch("both", "b", done.append)
        assert [tr.src for tr in eng._active[("a", "b")]] == ["a"]

        # a second read of an in-flight dataset piggybacks: it costs what
        # the transfer has left
        tr = eng._inflight[("in0", "b")]
        clock.advance(1.0)
        assert eng.expected_transfer_s("in0", "b") == pytest.approx(tr.eta - 1.0, rel=1e-12)
        queued = eng._inflight[("in3", "b")]
        assert eng.expected_transfer_s("in3", "b") == pytest.approx(
            eng.wait_s(SHARED_SITE, "b") + shared_hpc.expected_s(600.0), rel=1e-12
        )
        assert queued.state == "QUEUED"

        while len(done) < 5:
            clock.advance(1.0)
        assert done == [True] * 5
        assert eng.wait_s(SHARED_SITE, "b") == 0.0 and eng.queued_transfers() == 0
        assert eng._queued_mb[(SHARED_SITE, "b")] == 0.0
        assert all(reg.resident(n, "b") for n in ("in0", "in1", "in2", "in3", "both"))


def test_a_rerouted_queue_keeps_its_backlog_accounting():
    """A source-site death re-queues what it fed: the per-link byte count
    that prices the backlog follows each transfer to its new link."""
    with virtual_time(auto_advance=False) as clock:
        reg, eng = _engine(DatasetRegistry, TransferEngine)
        done = []
        for i in range(5):
            reg.add(f"in{i}", 300.0, sites=("a", SHARED_SITE))
            eng.fetch(f"in{i}", "b", done.append)
        # all five read from the cheaper source until its link is deep enough
        by_link = {k: len(v) for k, v in eng._active.items() if v}
        assert sum(by_link.values()) + eng.queued_transfers() == 5
        eng.site_down("a")
        assert all(tr.src == SHARED_SITE for trs in eng._active.values() for tr in trs)
        mb = sum(tr.size_mb for q in eng._queued.values() for tr in q)
        assert eng._queued_mb.get((SHARED_SITE, "b"), 0.0) == pytest.approx(mb)
        assert eng._queued_mb.get(("a", "b"), 0.0) == 0.0
        while len(done) < 5:
            clock.advance(1.0)
        assert done == [True] * 5 and eng.wait_s(SHARED_SITE, "b") == 0.0
