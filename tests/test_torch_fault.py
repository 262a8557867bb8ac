"""The port's ``SlabScheduler`` (``repro_torch.distributed.fault``) held to
the reference's straggler-requeue semantics: ``tests/test_fault.py``'s
three cases, each run on both packages' scheduler with the same fake
clock."""
import pytest

from repro.distributed import fault as j_fault
from repro_torch.distributed import fault as t_fault

PACKAGES = pytest.mark.parametrize("fault", [j_fault, t_fault],
                                   ids=["reference", "port"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@PACKAGES
def test_all_slabs_processed_in_order(fault):
    s = fault.SlabScheduler(4, timeout_s=10)
    got = []
    while not s.all_done:
        t = s.next_task(worker=0)
        assert t is not None
        assert s.complete(t.slab_id, t.epoch)
        got.append(t.slab_id)
    assert got == [0, 1, 2, 3]
    assert s.pending() == []


@PACKAGES
def test_straggler_requeued_and_stale_result_discarded(fault):
    clk = FakeClock()
    s = fault.SlabScheduler(2, timeout_s=5, now=clk)
    t0 = s.next_task(worker=0)        # worker 0 takes slab 0
    assert t0.slab_id == 0 and t0.epoch == 0
    t1 = s.next_task(worker=1)        # worker 1 takes slab 1
    assert s.complete(t1.slab_id, t1.epoch)
    assert s.next_task(worker=1) is None   # slab 0 not late yet
    clk.t = 6.0                       # worker 0 straggles past timeout
    assert s.next_task(worker=0) is None   # never requeued to itself
    t0b = s.next_task(worker=1)       # requeued to worker 1, epoch bumped
    assert t0b.slab_id == 0 and t0b.epoch == 1
    # the straggler finally reports: stale epoch -> discarded
    assert not s.complete(0, epoch=0)
    assert not s.all_done and s.pending() == [0]
    # the requeued run completes: accepted
    assert s.complete(0, epoch=1)
    assert s.all_done


@PACKAGES
def test_no_double_completion(fault):
    s = fault.SlabScheduler(1)
    t = s.next_task(0)
    assert s.complete(t.slab_id, t.epoch)
    assert not s.complete(t.slab_id, t.epoch)   # idempotent


def test_port_module_is_the_reference_copy():
    """Same classes and fields, so a trace of one replays on the other."""
    assert [f.name for f in j_fault.dataclasses.fields(j_fault.SlabTask)] \
        == [f.name for f in t_fault.dataclasses.fields(t_fault.SlabTask)]
    assert j_fault.SlabTask(3) == j_fault.SlabTask(**vars(t_fault.SlabTask(3)))
