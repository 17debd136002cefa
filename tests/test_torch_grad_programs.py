"""tools/torch_grad_programs.py on the port against the JAX package on the
CPU, at narrow widths: FGSM adversarial training of the book's digits
model (4 and 6 filters, batch 8) and the two input gradients over one
forward of the depth-8 CIFAR ResNet (is_test, drawn running statistics,
batch 4).

- Each program is op for op the JAX package's (main and startup; the FGSM
  step also at the book's widths).
- FGSM: 3 steps in lockstep with the JAX executor, each from its state
  (``params_from_numpy``). Every op of the port's plan, run on the JAX
  step's values of its inputs (``torch_resnet_step.replay``), within 1e-4
  of its largest JAX output (the repo's op limit); the whole step's clean
  and adversarial losses within 1e-5 relative; the parameters by
  ``adam_param_misses`` (Adam's update amplifies a gradient within
  rounding of 0, see tests/test_torch_book.py).
- ResNet: adv, the saliency map (the fetched ``img@GRAD``, the second
  gradient) and the loss within 1e-5 of their largest JAX magnitude (so no
  sign of the FGSM direction differs: a flip moves a pixel by 2 eps); the
  loss on adv within 1e-5 relative, and above the clean loss.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_grad_programs", os.path.join(ROOT, "tools",
                                        "torch_grad_programs.py"))
gp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gp)

TOL = 1e-5
STEPS = 3
BATCH = 8
RESNET = dict(dataset="cifar10", depth=8)


def _rel_max(got, want):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _pair(jg, tg, stats=None):
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jg.startup, scope=jscope)
    texe.run(tg.startup, scope=tscope)
    for n, v in (stats or {}).items():
        jscope.set(n, v)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in jg.main.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None}
    tfluid.params_from_numpy(state, tscope, "cpu")
    return (jexe, jscope), (texe, tscope), state


@pytest.mark.parametrize("narrow", [False, True], ids=["book", "narrow"])
def test_fgsm_program_is_op_for_op_the_jax_packages(narrow):
    cfg = gp.DIGITS_NARROW if narrow else {}
    jg, tg = gp.fgsm_digits(jfluid, **cfg), gp.fgsm_digits(tfluid, **cfg)
    assert step.signature(jg.main) == step.signature(tg.main)
    assert step.signature(jg.startup) == step.signature(tg.startup)
    types = [op.type for op in tg.main.global_block().ops]
    assert (len(types), types.count("grad_of"),
            types.count("batch_norm_grad"), types.count("adam")) == \
        (97, 42, 3, 8)


def test_fgsm_every_first_forward_op_has_two_grad_ops():
    """gradients(loss, [img]) and minimize both walk the clean forward:
    each of its conv, pool, batch norm and fc ops is taped once with two
    grad ops (the second frees the record); the adversarial forward's ops
    have one. The shared parameters' gradients are summed."""
    tg = gp.fgsm_digits(tfluid, **gp.DIGITS_NARROW)
    plan = texecutor._Plan(tg.main, [tg.loss.name, tg.loss_adv.name])
    steps = [op for op, _ in plan.steps]
    fwd_of = {}
    for k, f in plan.grad_fwd.items():
        fwd_of.setdefault(f, []).append(k)
    first = [k for k, op in enumerate(steps)
             if op.type in ("depthwise_conv2d", "conv2d", "pool2d",
                            "batch_norm", "mul")]
    assert len(first) == 2 * 6
    clean, adv = first[:6], first[6:]
    assert all(len(fwd_of[k]) == 2 for k in clean)
    assert all(len(fwd_of[k]) == 1 for k in adv)
    assert all(plan.last_grad[k] == max(fwd_of[k]) for k in clean)
    sums = [op for op in steps if op.type == "sum"]
    assert {op.output("Out")[0] for op in sums} >= {
        "conv0.w@GRAD", "conv1.w@GRAD", "bn.w@GRAD", "fc.w@GRAD"}


def test_fgsm_steps_in_lockstep_with_jax_executor():
    jg = gp.fgsm_digits(jfluid, **gp.DIGITS_NARROW)
    tg = gp.fgsm_digits(tfluid, **gp.DIGITS_NARROW)
    (jexe, jscope), (texe, tscope), state = _pair(jg, tg)
    block = tg.main.global_block()
    params = [p.name for p in tg.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params]
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    fetch = [tg.loss.name, tg.loss_adv.name]
    for k in range(STEPS):
        feed = gp.digits_batch(BATCH, seed=20 + k)
        tfluid.params_from_numpy(state, tscope, "cpu")
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            jg.main, feed=feed, fetch_list=inter, scope=jscope))))
        after = {n: np.asarray(jscope.get(n)) for n in state}
        errs = step.replay(tg.main, fetch, feed, state, after, vals)
        worst = max(errs, key=lambda e: e[2])
        assert worst[2] <= step.OP_TOL["float32"], worst
        got = texe.run(tg.main, feed=feed, fetch_list=fetch + grads,
                       scope=tscope)
        for g, n in zip(got[:2], fetch):
            assert abs(float(g) - float(vals[n])) <= TOL * abs(
                float(vals[n])), n
        assert float(vals[tg.loss_adv.name]) > float(vals[tg.loss.name])
        misses = step.adam_param_misses(
            tg.main, state, {n: tscope.get(n) for n in state}, after,
            dict(zip(grads, got[2:])), {g: vals[g] for g in grads})
        assert sorted(misses) == sorted(params)
        assert sum(misses.values()) == 0, misses
        state = after


def test_input_grads_program_is_op_for_op_the_jax_packages():
    jg = gp.input_grads_resnet(jfluid, **RESNET)
    tg = gp.input_grads_resnet(tfluid, **RESNET)
    assert step.signature(jg.main) == step.signature(tg.main)
    assert step.signature(jg.startup) == step.signature(tg.startup)
    types = [op.type for op in tg.main.global_block().ops]
    assert (types.count("grad_of"), types.count("batch_norm_grad")) == \
        (45, 18)
    assert tg.saliency.name == "img@GRAD"
    writers = [op for op in tg.main.global_block().ops
               if "img@GRAD" in op.output_arg_names]
    assert len(writers) == 2


def test_input_grads_match_jax_executor():
    """One run fetching adv, the saliency map and the loss; then the loss
    on adv (a second run with adv as the feed) is above the clean loss in
    both packages."""
    jg = gp.input_grads_resnet(jfluid, **RESNET)
    tg = gp.input_grads_resnet(tfluid, **RESNET)
    stats = gp.draw_bn_stats(tg.main, seed=3)
    (jexe, jscope), (texe, tscope), _ = _pair(jg, tg, stats)
    rng = np.random.RandomState(4)
    feed = {"img": rng.rand(4, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    fetch = [tg.adv.name, tg.saliency.name, tg.loss.name, "img@GRAD"]
    want = jexe.run(jg.main, feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tg.main, feed=feed, fetch_list=fetch, scope=tscope)
    for n, g, w in zip(fetch, got, want):
        assert _rel_max(g, w) <= TOL, n
    np.testing.assert_array_equal(got[1], got[3])
    # the fetched img@GRAD is the saliency map, not the FGSM direction
    # that adv was made from
    direction = np.round((step.f64(got[0]) - feed["img"]) / gp.RESNET_EPS)
    assert not np.array_equal(np.sign(got[1]), direction)
    adv_feed = dict(feed, img=got[0])
    adv_loss = [exe.run(g.main, feed=adv_feed, fetch_list=[g.loss.name],
                        scope=s)[0]
                for exe, g, s in ((jexe, jg, jscope), (texe, tg, tscope))]
    for a in adv_loss:
        assert float(a) > float(got[2])
    assert abs(float(adv_loss[1]) - float(adv_loss[0])) <= \
        TOL * abs(float(adv_loss[0]))
