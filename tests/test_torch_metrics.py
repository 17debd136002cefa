"""``fluid.metrics`` and ``fluid.evaluator`` on the port against the JAX
package's, on the CPU.

- Each metrics class (Precision, Recall, Accuracy, ChunkEvaluator,
  EditDistance, Auc, and a CompositeMetric of Precision and Recall) fed
  the same seeded arrays in both packages, three updates, then reset:
  every eval equal (the accumulators are numpy on the host in both). The
  port's also take tensors.
- ``evaluator.EditDistance`` in a program over three batches on both
  executors: its persistable states after each batch, ``eval`` and
  ``reset`` equal the JAX evaluator's; the program is op for op the JAX
  package's.
- The evaluator's edit_distance gets no lengths in both packages, so a
  padded row counts whole (ROADMAP Queue 3): [1, 2] against [1, 2, 5, 5]
  reads 0.5.
- A class that needs a later item raises and names ROADMAP Queue 1 item
  6: ``layers.Go`` (a host op; the DetectionMAPs are held in
  tests/test_torch_detection_layers.py, evaluator.ChunkEvaluator in
  tests/test_torch_compression.py).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

BATCHES = 3


def _feeds(kind, k):
    rng = np.random.RandomState(100 + k)
    if kind in ("Precision", "Recall", "Composite"):
        return (rng.rand(16, 1).astype(np.float32),
                rng.randint(0, 2, (16, 1)).astype(np.int64))
    if kind == "Accuracy":
        return (np.float32(rng.rand()), int(rng.randint(1, 9)))
    if kind == "ChunkEvaluator":
        infer, label = rng.randint(5, 9, 2)
        return (np.int64(infer), np.int64(label),
                np.int64(rng.randint(0, min(infer, label) + 1)))
    if kind == "EditDistance":
        d = rng.randint(0, 3, (6, 1)).astype(np.float32)
        return (d, np.int64(6))
    if kind == "Auc":
        return (rng.rand(32, 2).astype(np.float32),
                rng.randint(0, 2, (32, 1)).astype(np.int64))
    raise KeyError(kind)


def _metric(fluid, kind):
    m = fluid.metrics
    if kind == "Composite":
        c = m.CompositeMetric()
        c.add_metric(m.Precision())
        c.add_metric(m.Recall())
        return c
    if kind == "Auc":
        return m.Auc(num_thresholds=63)
    return getattr(m, kind)()


KINDS = ["Precision", "Recall", "Accuracy", "ChunkEvaluator",
         "EditDistance", "Auc", "Composite"]


@pytest.mark.parametrize("kind", KINDS)
def test_metric_matches_the_jax_packages(kind):
    j, t = _metric(jfluid, kind), _metric(tfluid, kind)
    for k in range(BATCHES):
        args = _feeds(kind, k)
        j.update(*args)
        # the port's takes the fetched tensors as well as arrays
        t.update(*[torch.as_tensor(a) if k % 2 and
                   isinstance(a, np.ndarray) else a for a in args])
        assert t.eval() == j.eval(), (kind, k)
    j.reset()
    t.reset()
    if kind in ("Accuracy", "EditDistance"):
        for m in (j, t):
            with pytest.raises(ValueError):
                m.eval()
    else:
        assert t.eval() == j.eval()


def test_the_modules_export_the_jax_packages_names():
    assert tfluid.metrics.__all__ == jfluid.metrics.__all__
    assert tfluid.evaluator.__all__ == jfluid.evaluator.__all__
    assert {"metrics", "evaluator"} <= set(tfluid.__all__)


def _program(fluid, t=6, n=4):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        hyp = fluid.layers.data(name="hyp", shape=[t], dtype="int64")
        ref = fluid.layers.data(name="ref", shape=[n], dtype="int64")
        ev = fluid.evaluator.EditDistance(input=hyp, label=ref)
    return main, startup, ev


def _batch(k, b=5, t=6, n=4):
    rng = np.random.RandomState(200 + k)
    return {"hyp": rng.randint(0, 4, (b, t)).astype(np.int64),
            "ref": rng.randint(0, 4, (b, n)).astype(np.int64)}


def _states(fluid, ev, scope):
    return [np.asarray(fluid.executor.as_numpy(scope.get(v.name))
                       if fluid is tfluid else scope.get(v.name))
            for v in ev.states]


def test_edit_distance_evaluator_matches_the_jax_evaluator():
    runs = {}
    for fluid in (jfluid, tfluid):
        main, startup, ev = _program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        seen = []
        with fluid.scope_guard(scope):
            exe.run(startup)
            for k in range(BATCHES):
                exe.run(main, feed=_batch(k), fetch_list=ev.metrics)
                seen.append((_states(fluid, ev, scope), ev.eval(exe)))
            ev.reset(exe)
            seen.append((_states(fluid, ev, scope), ev.eval(exe)))
            # the states go on accumulating after a reset
            exe.run(main, feed=_batch(9), fetch_list=ev.metrics)
            seen.append((_states(fluid, ev, scope), ev.eval(exe)))
        runs[fluid] = (main, seen)
    assert step.signature(runs[jfluid][0]) == step.signature(runs[tfluid][0])
    for (js, je), (ts, te) in zip(runs[jfluid][1], runs[tfluid][1]):
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                          np.asarray(b).reshape(-1))
        for a, b in zip(je, te):
            np.testing.assert_array_equal(a, b)
            assert b.dtype == np.float32
    states, (avg, err) = runs[tfluid][1][BATCHES]
    assert all(not np.asarray(s).any() for s in states)
    assert avg[0] == err[0] == 0.0
    assert runs[tfluid][1][0][1][0][0] > 0


def test_evaluator_counts_padded_rows_whole_in_both_packages():
    """No lengths reach the evaluator's edit_distance: the decoded [1, 2]
    against the label [1, 2, 5, 5], whose 5s are padding, reads 2 / 4."""
    feed = {"hyp": np.array([[1, 2]], np.int64),
            "ref": np.array([[1, 2, 5, 5]], np.int64)}
    for fluid in (jfluid, tfluid):
        main, startup, ev = _program(fluid, t=2, n=4)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            d, n = exe.run(main, feed=feed, fetch_list=ev.metrics)
            assert float(np.asarray(d).reshape(())) == 0.5
            assert ev.eval(exe)[0][0] == 0.5


@pytest.mark.parametrize("build", [
    lambda fluid: fluid.layers.Go(),
], ids=["layers.Go"])
def test_classes_of_later_items_now_build(build):
    """layers.Go, which waited for the host ops, builds its block and its
    go op as the JAX package's does."""
    progs = []
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            with build(fluid).block():
                fluid.layers.mean(x)
        progs.append([(op.type, dict(op.inputs), dict(op.attrs))
                      for op in main.global_block().ops])
    assert progs[0] == progs[1]
    assert progs[1][0][0] == "go"
