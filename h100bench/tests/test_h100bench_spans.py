"""h100bench/spans.py on hand-made stretches: an idle gap falls to the
span of the launch that ended it; a kernel launched on a second thread
falls to the span open on the main thread at its launch, or to a span
open on its own thread; and a CPU profile of the program's ranges reads
back with their threads."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from h100bench import spans

MAIN, AUTOGRAD = 1, 2
# one step on the main thread (us): the gradients cleared, the backward,
# then the update; a recompute's dropout span on autograd's thread
SPANS = [("w2v.step", MAIN, 0.0, 1000.0),
         ("w2v.optimizer", MAIN, 90.0, 100.0),
         ("w2v.backward", MAIN, 100.0, 400.0),
         ("w2v.optimizer", MAIN, 400.0, 900.0),
         ("w2v.dropout", AUTOGRAD, 250.0, 300.0)]


def _table(device):
    st = spans.Stretch(SPANS, device, 0.0, 1000.0)
    return spans.attribute(st), spans.table(st, steps=1)


def test_a_gap_ended_inside_the_optimizer_falls_to_it():
    # busy 150-250; idle 250-600 ended by a launch inside the update
    names, t = _table([(150.0, 100.0, (MAIN, 120.0)),
                       (600.0, 50.0, (MAIN, 450.0))])
    assert names == ["w2v.backward", "w2v.optimizer"]
    assert t["w2v.optimizer"]["idle_ms"] == pytest.approx(0.35)
    assert t["w2v.backward"]["idle_ms"] == pytest.approx(0.15)
    # the idle after the last operation is ended by no launch
    assert t[spans.NONE]["idle_ms"] == pytest.approx(0.35)
    assert t["(stretch)"]["idle_ms"] == pytest.approx(0.85)
    assert t["(stretch)"]["in_spans"] == pytest.approx(100 * 0.5 / 0.85)
    assert t["w2v.optimizer"]["host_ms"] == pytest.approx(0.51)


def test_a_kernel_from_a_second_thread_falls_to_the_backward():
    names, t = _table([(210.0, 40.0, (AUTOGRAD, 200.0))])
    assert names == ["w2v.backward"]
    assert t["w2v.backward"]["device_ms"] == pytest.approx(0.04)


def test_a_kernel_in_a_nested_dropout_on_that_thread_falls_to_it():
    names, t = _table([(210.0, 40.0, (AUTOGRAD, 200.0)),
                       (270.0, 20.0, (AUTOGRAD, 260.0)),
                       (320.0, 5.0, (AUTOGRAD, 310.0))])
    assert names == ["w2v.backward", "w2v.dropout", "w2v.backward"]
    assert t["w2v.dropout"]["device_ms"] == pytest.approx(0.02)
    assert t["w2v.dropout"]["other_ms"] == pytest.approx(0.05)
    assert t["w2v.dropout"]["host_ms"] == 0.0


def test_a_cpu_profile_reads_back_its_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("w2v.step"):
            with record_function("w2v.forward"):
                torch.ones(8).sum()
    st = spans.stretch(prof)
    assert [s[0] for s in sorted(st.spans, key=lambda s: s[2])] == [
        "w2v.step", "w2v.forward"]
    assert spans.main_thread(st) == st.spans[0][1]
    assert st.device == [] and st.start <= st.spans[0][2] < st.end
