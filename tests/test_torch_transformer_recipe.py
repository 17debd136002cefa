"""The Fluid Transformer's training recipe in the port against the JAX
package on the CPU, at a small size (1 layer, d_model 64, vocab 128,
seq 16): label smoothing 0.1 (one_hot -> label_smooth -> soft-label
softmax_with_cross_entropy), Adam(beta1 0.9, beta2 0.997, epsilon 1e-9) at
the learning rate noam_decay(d_model, 8000) * 2.0, built through the public
API as a user builds it.

The programs must be op for op the JAX package's (startup included); with
the JAX package's state carried over by params_from_numpy, one step's loss
and gradients agree at tests/test_torch_backward.py's float32 tolerances
(the loss to 1e-5 relative, each gradient to 1e-4 of its largest magnitude
plus 1e-7), and three run_steps steps' losses to 1e-5 relative, their
learning rates to 1e-6 relative, their parameters to 1e-6 absolute (a
step moves a weight by under 1e-6 at the Noam rate of the first steps).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(n_layer=1, d_model=64, n_head=2, d_ff=128, seq_len=16,
             src_vocab=128, tgt_vocab=128, dropout_rate=0.0)
EPS = 0.1
WARMUP = 8000
COUNTER = "@LR_DECAY_COUNTER@"


def _recipe(fl, transformer, **cfg):
    """The recipe through the public API. Returns (main, startup, loss,
    lr)."""
    cfg = dict(SMALL, **cfg)
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 11
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        _, loss = transformer.build(label_smooth_eps=EPS, **cfg)
        lr = fl.layers.noam_decay(cfg["d_model"], WARMUP) * 2.0
        fl.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                          epsilon=1e-9).minimize(loss)
    return main, startup, loss, lr


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient)
             for v in b.vars.values()]
    return ops, vars_


def _noam(step, d_model=SMALL["d_model"]):
    return 2.0 * d_model ** -0.5 * min(step ** -0.5, step * WARMUP ** -1.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_programs_are_op_for_op_identical(dtype):
    jm, js, _, _ = _recipe(jfluid, jtransformer, dtype=dtype)
    tm, ts, _, _ = _recipe(tfluid, ttransformer, dtype=dtype)
    assert _signature(tm) == _signature(jm)
    assert _signature(ts) == _signature(js)
    ops = tm.global_block().ops
    types = [op.type for op in ops]
    assert types[0] == "increment"
    k = types.index("label_smooth")
    assert types[k - 1] == "one_hot" and types[k + 1] == \
        "softmax_with_cross_entropy"
    assert ops[k + 1].attr("soft_label") is True
    assert ops[k].attr("epsilon") == EPS
    adam = [op for op in ops if op.type == "adam"]
    assert len(adam) == len(tm.all_parameters())
    assert {(op.attr("beta1"), op.attr("beta2"), op.attr("epsilon"))
            for op in adam} == {(0.9, 0.997, 1e-9)}
    assert len({tuple(op.input("LearningRate")) for op in adam}) == 1


def test_label_smoothing_no_longer_raises():
    with tfluid.unique_name.guard(), tfluid.program_guard(tfluid.Program(),
                                                          tfluid.Program()):
        _, loss = ttransformer.build(label_smooth_eps=0.1, **SMALL)
    assert loss.name


def _pair():
    jm, js, jloss, jlr = _recipe(jfluid, jtransformer)
    tm, ts, tloss, tlr = _recipe(tfluid, ttransformer)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [v.name for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    return (jm, jexe, jscope, jloss, jlr), (tm, texe, tscope, tloss,
                                            tlr), names


def _f32(x):
    return np.asarray(texecutor.as_numpy(x), dtype=np.float32)


def test_one_recipe_step_matches_jax_executor():
    j, t, _ = _pair()
    batch = jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                         SMALL["tgt_vocab"], 0)
    grads = [p.name + "@GRAD" for p in j[0].all_parameters()]
    fetch = [j[3].name, j[4].name] + grads
    want = [_f32(w) for w in j[1].run(j[0], feed=batch, fetch_list=fetch,
                                      scope=j[2])]
    got = [_f32(g) for g in t[1].run(t[0], feed=batch, fetch_list=fetch,
                                     scope=t[2])]
    assert got[0].shape == () and abs(got[0] - want[0]) <= 1e-5 * want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[1], [_noam(1)], rtol=1e-6)
    for name, w, g in zip(grads, want[2:], got[2:]):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, name


def test_three_recipe_run_steps_match_jax_executor():
    j, t, names = _pair()
    steps = [jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                          SMALL["tgt_vocab"], seed)
             for seed in (1, 2, 3)]
    stacked = {n: np.stack([s[n] for s in steps]) for n in steps[0]}
    want = j[1].run_steps(j[0], feed=stacked, n_steps=3,
                          fetch_list=[j[3].name, j[4].name], scope=j[2])
    got = t[1].run_steps(t[0], feed=stacked, n_steps=3,
                         fetch_list=[t[3].name, t[4].name], scope=t[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1].reshape(-1), np.asarray(
        want[1]).reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(got[1].reshape(-1),
                               [_noam(s) for s in (1, 2, 3)], rtol=1e-6)
    assert int(t[2].get(COUNTER)[0]) == int(np.asarray(j[2].get(COUNTER))[0])
    assert int(t[2].get(COUNTER)[0]) == 3
    params = {p.name for p in j[0].all_parameters()}
    for n in names:
        if n in params:
            np.testing.assert_allclose(_f32(t[2].get(n)), _f32(j[2].get(n)),
                                       rtol=0, atol=1e-6, err_msg=n)
        elif "pow_acc" in n:
            np.testing.assert_allclose(_f32(t[2].get(n)), _f32(j[2].get(n)),
                                       rtol=1e-6, err_msg=n)


def test_clone_for_test_and_prune_treat_the_counter_as_jax():
    """clone(for_test=True) keeps the step counter's increment op (its role
    is forward) and the schedule's ops, as in the JAX package; pruning to
    the logits drops them, as save_inference_model does."""
    def shapes(fl, transformer):
        main, _, loss, _ = _recipe(fl, transformer)
        test = main.clone(for_test=True)
        logits = [op.input("Logits")[0] for op in main.global_block().ops
                  if op.type == "softmax_with_cross_entropy"][0]
        pruned = test._prune(["src_ids", "tgt_ids"], [logits])
        return ([op.type for op in test.global_block().ops],
                [op.type for op in pruned.global_block().ops])
    jt, jp = shapes(jfluid, jtransformer)
    tt, tp = shapes(tfluid, ttransformer)
    assert tt == jt and tp == jp
    assert tt[0] == "increment" and "adam" not in tt
    assert "increment" not in tp and "label_smooth" not in tp


def test_soft_labels_take_the_plain_cross_entropy(monkeypatch):
    """With FLAGS_ce_kernel on and the gate's card test forced true, the
    recipe's soft-label cross-entropy still takes the plain route: the CE
    kernels take hard labels only, as the JAX gate."""
    from paddle_tpu_torch.fluid.ops import common
    from paddle_tpu_torch.ops import ce_kernel as tce
    calls = []
    for name in ("ce_forward", "ce_backward"):
        monkeypatch.setattr(tce, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(common, "on_card", lambda x: True)
    monkeypatch.setenv("FLAGS_ce_kernel", "1")
    tm, ts, tloss, _ = _recipe(tfluid, ttransformer)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    batch = ttransformer.synthetic_batch(2, SMALL["seq_len"],
                                         SMALL["tgt_vocab"], 0)
    loss, = exe.run(tm, feed=batch, fetch_list=[tloss], scope=scope)
    assert np.isfinite(loss) and calls == []
