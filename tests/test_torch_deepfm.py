"""The port's DeepFM (paddle_tpu_torch.models.deepfm) and its sparse row
gradients against the JAX package's on the CPU, at a small size: 4 fields,
vocab 500, embed 8, MLP 128-64, batch 16.

Both embeddings are sparse: their gradients are (values, rows) pairs that
sparse sgd and adam take, or that a regularizer, a clip or an optimizer
without a sparse update densifies first. The programs must be op-for-op
the JAX package's, startup included. With the JAX package's parameters,
optimizer state and AUC histograms carried over by params_from_numpy, both
executors run three steps on batches whose ids repeat (drawn from 40 of the
500 rows), and must agree each step on the loss, the AUC and the sparse
gradient pair, and after the steps on every persistable: float32, summation
order only, 1e-5 relative plus 1e-7 (tests/test_torch_optimizer.py's
tolerance); the pair's rows and the histograms exactly. Inputs come from
seeded numpy.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import deepfm as jdeepfm
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import deepfm as tdeepfm

SMALL = dict(num_fields=4, vocab_size=500)
BATCH, ID_RANGE = 16, 40

# name -> (optimizer, gradient clip), each built against one package
SETUPS = {
    "adam": (lambda fl: fl.optimizer.Adam(1e-3), None),
    "adam_lazy": (lambda fl: fl.optimizer.Adam(1e-3, lazy_mode=True), None),
    "sgd": (lambda fl: fl.optimizer.SGD(0.1), None),
    "adam_l2decay": (lambda fl: fl.optimizer.Adam(
        1e-3, regularization=fl.regularizer.L2Decay(1e-3)), None),
    "adam_global_norm": (lambda fl: fl.optimizer.Adam(1e-3),
                         lambda fl: fl.clip.GradientClipByGlobalNorm(0.5)),
}
# the setups whose sparse pairs go to the optimizer op as they are
SPARSE_TO_OPTIMIZER = {"adam", "adam_lazy", "sgd"}


def _build(fluid, deepfm, setup, **cfg):
    opt, clip = SETUPS[setup]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss, auc = deepfm.build(**dict(SMALL, **cfg))
        if clip is not None:
            params = [p.name for p in main.all_parameters()]
            fluid.clip.set_gradient_clip(clip(fluid), param_list=params,
                                         program=main)
        opt(fluid).minimize(loss)
    return main, startup, loss, auc


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_programs_are_op_for_op_identical(setup):
    j = _build(jfluid, jdeepfm, setup)
    t = _build(tfluid, tdeepfm, setup)
    for jp, tp in zip(j[:2], t[:2]):
        assert _signature(jp) == _signature(tp)
    ops = t[0].global_block().ops
    grads = [op for op in ops if op.type == "lookup_table_grad"]
    assert len(grads) == 2 and all(op.attrs["is_sparse"] for op in grads)
    update = [op for op in ops if op.type == SETUPS[setup][0](tfluid).type]
    rows = [op.input("GradRows") for op in update]
    densify = [op for op in ops if op.type == "selected_rows_densify"]
    if setup in SPARSE_TO_OPTIMIZER:
        assert sorted(r[0] for r in rows if r) == [
            "fm_first@GRAD@ROWS", "fm_second@GRAD@ROWS"] and not densify
    else:
        assert not any(rows) and len(densify) == 2


def test_a_table_with_two_readers_takes_the_dense_grad():
    """A sparse table read by two lookups: backward sums the two grads, so
    both are dense (no @ROWS pair), as in the JAX package."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            ids = fl.layers.data(name="ids", shape=[3], dtype="int64")
            attr = fl.ParamAttr(name="tbl")
            a = fl.layers.embedding(ids, size=[20, 4], is_sparse=True,
                                    param_attr=attr)
            b = fl.layers.embedding(ids, size=[20, 4], is_sparse=True,
                                    param_attr=attr)
            loss = fl.layers.mean(fl.layers.elementwise_add(a, b))
            fl.optimizer.Adam(1e-3).minimize(loss)
        return main
    jm, tm = build(jfluid), build(tfluid)
    assert _signature(jm) == _signature(tm)
    ops = tm.global_block().ops
    assert not any(op.input("GradRows") for op in ops if op.type == "adam")
    assert not any(op.attrs.get("is_sparse") for op in ops
                   if op.type == "lookup_table_grad")


def test_distributed_embeddings_raise():
    with tfluid.unique_name.guard(), tfluid.program_guard(tfluid.Program(),
                                                          tfluid.Program()):
        with pytest.raises(NotImplementedError):
            tdeepfm.build(distributed=True, **SMALL)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                               err_msg=err_msg)


def _f64(x):
    return np.asarray(texecutor.as_numpy(x), dtype=np.float64)


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_three_steps_match_jax_executor(setup):
    j = _build(jfluid, jdeepfm, setup)
    t = _build(tfluid, tdeepfm, setup)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    names = [v.name for v in j[0].global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    assert "auc_0_stat_pos" in names and "fm_second" in names
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    fetch = [j[2].name, j[3].name]
    if setup in SPARSE_TO_OPTIMIZER:
        fetch += ["fm_second@GRAD", "fm_second@GRAD@ROWS"]
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = tdeepfm.synthetic_batch(BATCH, SMALL["num_fields"], ID_RANGE,
                                       seed=rng.randint(1 << 30))
        assert len(np.unique(feed["feat_ids"])) < feed["feat_ids"].size
        want = [_f64(w) for w in jexe.run(j[0], feed=feed, fetch_list=fetch,
                                          scope=jscope)]
        got = [_f64(g) for g in texe.run(t[0], feed=feed, fetch_list=fetch,
                                         scope=tscope)]
        for name, g, w in zip(fetch, got, want):
            assert g.shape == w.shape, name
            if name.endswith("@ROWS"):
                np.testing.assert_array_equal(g, w)
            else:
                _close(g, w, name)
    for n in names:
        want, got = _f64(jscope.get(n)), _f64(tscope.get(n))
        if "_stat_" in n:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            _close(got, want, n)
