"""The port's tracer (``utils/trace.py``) through the Trainer on the CPU,
where the device marks read the host clock: the three training routes with
tracing off and on, the spans' nesting and indices, the report's arithmetic
on hand-counted spans, the rings' drops and the profiler's ranges.  The
stamp kernel itself, the graph's stamps and the clock's calibration are
checked on the card by ``tools/trace_check.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
from torecsys_tpu_torch.ops.kernels import trace as stamp_kernel
from torecsys_tpu_torch.utils import trace

# (sparse, presort): the trusted presorted route, the on-device one, the dense one
ROUTES = {"presorted": (True, None), "ondevice": (True, False), "dense": (False, None)}
K = 3
STAMP = stamp_kernel.stamp  # the wrapper, whose ``launches`` the fixture leaves alone


def _batches(n, seed=0, b=16, vocab=10):
    rng = np.random.default_rng(seed)
    return [{"c": rng.integers(0, vocab, b).astype(np.int32),
             "d": rng.normal(size=b).astype(np.float32),
             "label": (rng.uniform(size=b) < 0.5).astype(np.float32)} for _ in range(n)]


def _trainer(route, spe=K):
    sparse, presort = ROUTES[route]
    inputs = Inputs({"feat_inputs": ValueInput(("d",)),
                     "emb_inputs": MultiIndicesEmbedding(4, (10,), ("c",), device="cpu")})
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(inputs)
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-2).set_sparse_embeddings(sparse)
            .set_target_fields("label"))
    trainer = Trainer(pipe, log_every=1000, steps_per_execution=spe, presort=presort)
    trainer.init_state()
    return trainer


@pytest.fixture
def stamps(monkeypatch):
    """Counts the tracer's stamps (on the CPU ``stamp.launches`` counts
    kernel launches only, and stays 0)."""
    calls = []

    def counted(buf, index):
        calls.append(index)
        STAMP(buf, index)

    monkeypatch.setattr(stamp_kernel, "stamp", counted)
    return calls


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tracing_off_records_nothing_and_sums_host_ms(route, stamps):
    trainer = _trainer(route)
    launches = STAMP.launches
    trainer.train_steps(_batches(7))
    assert stamps == [] and STAMP.launches == launches
    assert trainer.spans() == []
    assert set(trainer.host_ms) == {"presort", "pack", "wait", "place", "step"}
    for stage in ("pack", "wait", "place", "step"):
        assert trainer.host_ms[stage] > 0, stage
    assert (trainer.host_ms["presort"] > 0) == (route == "presorted")
    report = trainer.trace_report()
    assert report["steps"] == 0 and report["span_ms"] == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tracing_keeps_the_losses_and_parameters_to_the_bit(route, stamps):
    """7 batches in dispatches of 3: two K-step dispatches and an eager
    remainder, with tracing off and on from the same start."""
    runs = []
    for traced in (False, True):
        trainer = _trainer(route)
        trainer.set_tracing(traced)
        losses = torch.stack(trainer.train_steps(_batches(7))).tolist()
        runs.append((losses, [p.detach().clone() for p in
                              trainer.pipeline.sequential.parameters()]))
    assert stamps  # the traced run stamped
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_step_has_its_nested_spans(route):
    trainer = _trainer(route)
    trainer.set_tracing(True)
    trainer.train_steps(_batches(7))
    spans = trainer.spans()
    by_id = {s.id: s for s in spans}
    device = [s for s in spans if s.device]
    steps = sorted({s.step for s in device})
    assert steps == list(range(7))
    names = {"step", "forward", "lookup", "backward", "dense_optimizer"}
    if route != "dense":
        names.add("sparse_update")
    for step in steps:
        mine = {s.name: s for s in device if s.step == step and s.name != "copy_in"}
        assert set(mine) == names
        assert len({s.dispatch for s in mine.values()}) == 1
        assert mine["step"].parent is None
        assert by_id[mine["forward"].parent] is mine["step"]
        assert by_id[mine["lookup"].parent] is mine["forward"]
        for name in names - {"step", "forward", "lookup"}:
            assert by_id[mine[name].parent] is mine["step"]
        order = [mine["step"].start_ns, mine["lookup"].start_ns, mine["lookup"].end_ns,
                 mine["forward"].end_ns, mine["backward"].end_ns,
                 mine["dense_optimizer"].end_ns, mine["step"].end_ns]
        assert order == sorted(order)
    # the two K-step dispatches copy their group in; the remainder's step does not
    copies = [s for s in device if s.name == "copy_in"]
    assert [(s.dispatch, s.step) for s in copies] == [(0, 0), (1, 3)]
    host = [s for s in spans if not s.device]
    assert [s.dispatch for s in host if s.name == "wait"] == [0, 1, 2, 3]
    assert [(s.dispatch, s.step) for s in host if s.name == "step"] == [(0, 0), (1, 3), (2, 6)]
    packs = [s for s in host if s.name == "pack"]
    assert [(s.dispatch, s.step) for s in packs] == [(0, 0), (1, 3), (2, 6)]
    if route == "presorted":  # in the prefetch workers
        assert all(s.parent is None and s.thread != copies[0].thread for s in packs)
    else:  # on the loop's thread, inside its wait
        assert all(by_id[s.parent].name == "wait" for s in packs)

    trainer.train_steps(_batches(6, seed=1))
    report = trainer.trace_report()
    assert report["steps"] == 6 and report["dispatches"] == 2
    assert set(report["span_ms"]) == names | {"copy_in"}
    assert all(v >= 0 for v in report["span_ms"].values())
    assert report["uncertainty_us"] == 0.0 and report["dropped"] == {"host": 0, "device": 0}
    assert sum(report["gap_by_host"].values()) == pytest.approx(report["gap_ms"])
    assert (sum(report["span_ms"].values()) + report["other_ms"] + report["gap_ms"]
            == pytest.approx(report["wall_ms"]))
    assert trainer.spans() == []  # read once


def _span(id_, name, start, end, parent=None, dispatch=0, step=0, device=True, thread=1):
    return trace.Span(id_, name, start, end, parent, dispatch, step, device, thread)


def test_the_report_of_hand_counted_spans():
    """Two dispatches of one step, ns on one clock: dispatch 0 copies in
    over [0, 10) and steps over [10, 100); dispatch 1 starts at 150.  The
    gap [100, 150) is overlapped by the loop's ``wait`` over [90, 120) and
    its ``step`` over [130, 140); a worker's ``pack`` does not count."""
    spans = [
        _span(1, "copy_in", 0, 10), _span(2, "step", 10, 100),
        _span(3, "forward", 10, 40, parent=2), _span(4, "lookup", 15, 25, parent=3),
        _span(5, "backward", 40, 70, parent=2), _span(6, "dense_optimizer", 70, 90, parent=2),
        _span(7, "copy_in", 150, 160, dispatch=1, step=1),
        _span(8, "step", 165, 255, dispatch=1, step=1),
        _span(9, "forward", 165, 195, parent=8, dispatch=1, step=1),
        _span(10, "wait", 90, 120, device=False), _span(11, "step", 130, 140, device=False),
        _span(12, "pack", 100, 150, device=False, thread=2),
    ]
    r = trace.reduce(spans)
    per_step = 2 * 1e6
    assert r["steps"] == 2 and r["dispatches"] == 2
    assert r["span_ms"] == {"copy_in": 20 / per_step, "step": 70 / per_step,
                            "forward": 50 / per_step, "lookup": 10 / per_step,
                            "backward": 30 / per_step, "dense_optimizer": 20 / per_step}
    assert r["other_ms"] == 5 / per_step  # [160, 165)
    assert r["gap_ms"] == 50 / per_step
    assert r["gap_by_host"] == {"wait": 20 / per_step, "place": 0.0, "step": 10 / per_step,
                                "other": 20 / per_step}
    assert r["wall_ms"] == 255 / per_step


def test_the_rings_count_their_drops():
    """A tracer keeping one dispatch (16 host spans) over 10 eager
    dispatches: 4 host spans each (wait, pack, place, step) and the last
    wait."""
    trainer = _trainer("dense", spe=1)
    trainer.tracer = trace.Tracer(trainer.device, capacity=1)
    trainer.set_tracing(True)
    trainer.train_steps(_batches(10))
    report = trainer.trace_report()
    assert report["dropped"] == {"host": 41 - 16, "device": 10 - 1}
    assert report["steps"] == 1 and report["dispatches"] == 1
    assert trainer.trace_report()["dropped"] == {"host": 0, "device": 0}


@pytest.mark.parametrize("traced", [False, True])
def test_a_profiler_sees_the_host_stages(traced):
    """The loop thread's stages, tracing on or off (the on-device route
    packs on that thread; the profiler records no worker thread's ranges)."""
    trainer = _trainer("ondevice")
    trainer.set_tracing(traced)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_steps(_batches(6))
    names = {e.name for e in prof.events()}
    assert {"torecsys.wait", "torecsys.step", "torecsys.pack"} <= names
