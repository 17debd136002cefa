"""The Fluid book's straight-line models (tools/torch_book_models.py) and
the loss layers of ``fluid.layers`` on the port, against the JAX package on
the CPU.

- Each of the 14 layers (cross_entropy, square_error_cost, l2_normalize
  and the other losses) in a small program (an fc, the layer, mean, SGD):
  op for op the JAX package's, main and startup; and one step from the
  JAX package's parameters, the loss within 1e-5 relative and the fc's
  gradients within 1e-5 of their largest JAX magnitude.
- The five book programs, at the book's widths and at narrow ones
  (``NARROW``: a few filters, depth 8, a small vocabulary): op for op,
  main and startup (so the optimizers' accumulators too).
- Three training steps of each at the narrow widths in lockstep with the
  JAX executor, each from its state (``fluid.params_from_numpy``): every
  op on the JAX values of its inputs within 1e-4, the whole step's loss
  within 1e-5 relative, and the Adam models' parameters by
  ``adam_param_misses`` (tests/torch_resnet_step.py: Adam's update
  amplifies a gradient within rounding of 0 or of eps / sqrt(1 - beta2),
  and a free-running run carries it on: the depth-8 ResNet's second loss
  reads 4.5e-5 apart); see the test for the rest. The three SGD models
  also free-running through run_steps, everything within 1e-5.
- recognize_digits_conv and word2vec saved by the port's
  save_inference_model, loaded back by the port and by the JAX package,
  and served: the same predictions.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_book_models", os.path.join(ROOT, "tools", "torch_book_models.py"))
book = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(book)

TOL = 1e-5
STEPS = 3
STEP_BATCH = {"fit_a_line": 20, "recognize_digits_conv": 16,
              "image_classification": 16, "word2vec": 32,
              "recommender_system": 32}


def _rel_max(got, want):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _pair(jb, tb):
    """Both executors after the JAX startup, the port holding its state."""
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jb.startup, scope=jscope)
    texe.run(tb.startup, scope=tscope)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in jb.main.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None}
    tfluid.params_from_numpy(state, tscope, "cpu")
    return (jexe, jscope), (texe, tscope), state


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

def _float(L, name, shape):
    return L.data(name=name, shape=shape, dtype="float32")


def _int(L, name, shape):
    return L.data(name=name, shape=shape, dtype="int64")


# name -> fn(fluid, h) building the layer on h = fc(x, 5) ([N, 5]), with
# the feeds it adds beside x
LAYERS = {
    "cross_entropy": lambda fl, h: fl.layers.cross_entropy(
        fl.layers.softmax(h), _int(fl.layers, "label", [1])),
    "square_error_cost": lambda fl, h: fl.layers.square_error_cost(
        h, _float(fl.layers, "y", [5])),
    "l2_normalize": lambda fl, h: fl.layers.l2_normalize(h, axis=1),
    "log_loss": lambda fl, h: fl.layers.log_loss(
        fl.layers.sigmoid(h), _float(fl.layers, "y", [5])),
    "huber_loss": lambda fl, h: fl.layers.huber_loss(
        h, _float(fl.layers, "y", [5]), 0.5),
    "kldiv_loss": lambda fl, h: fl.layers.kldiv_loss(
        h, fl.layers.softmax(_float(fl.layers, "y", [5])),
        reduction="batchmean"),
    "npair_loss": lambda fl, h: fl.layers.npair_loss(
        h, _float(fl.layers, "y", [5]),
        fl.layers.reshape(_int(fl.layers, "label", [1]), [-1])),
    "teacher_student_sigmoid_loss":
        lambda fl, h: fl.layers.teacher_student_sigmoid_loss(
            fl.layers.slice(h, [1], [0], [1]),
            fl.layers.sigmoid(_float(fl.layers, "y", [1]))),
    "smooth_l1": lambda fl, h: fl.layers.smooth_l1(
        h, _float(fl.layers, "y", [5]), sigma=2.0),
    "bpr_loss": lambda fl, h: fl.layers.bpr_loss(
        h, _int(fl.layers, "label", [1])),
    "rank_loss": lambda fl, h: fl.layers.rank_loss(
        _float(fl.layers, "y", [1]), fl.layers.slice(h, [1], [0], [1]),
        fl.layers.slice(h, [1], [1], [2])),
    "margin_rank_loss": lambda fl, h: fl.layers.margin_rank_loss(
        _float(fl.layers, "y", [1]), fl.layers.slice(h, [1], [0], [1]),
        fl.layers.slice(h, [1], [1], [2])),
    "dice_loss": lambda fl, h: fl.layers.dice_loss(
        fl.layers.softmax(h), _int(fl.layers, "label", [1])),
    "hinge_loss": lambda fl, h: fl.layers.hinge_loss(
        fl.layers.slice(h, [1], [0], [1]), _float(fl.layers, "y", [1])),
}


def _layer_programs(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=5)
        loss = fluid.layers.mean(LAYERS[name](fluid, h))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _layer_feed(main, n=6):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(n, 4).astype("float32")}
    block = main.global_block()
    if "y" in block.vars:
        feed["y"] = rng.randn(n, block.var("y").shape[1]).astype("float32")
        if block.var("y").shape[1] == 1:
            feed["y"] = np.sign(feed["y"]).astype("float32")
    if "label" in block.vars:
        feed["label"] = rng.randint(0, 5, (n, 1)).astype("int64")
    return feed


def test_the_layers_are_exported():
    import inspect
    for name in LAYERS:
        fn = getattr(tfluid.layers, name)
        assert inspect.signature(fn) == inspect.signature(
            getattr(jfluid.layers, name)), name


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_program_matches_jax(name):
    jm, js, jloss = _layer_programs(jfluid, name)
    tm, ts, tloss = _layer_programs(tfluid, name)
    assert step.signature(jm) == step.signature(tm)
    assert step.signature(js) == step.signature(ts)
    jb = book.Book(jm, js, jloss, None, None, None)
    tb = book.Book(tm, ts, tloss, None, None, None)
    (jexe, jscope), (texe, tscope), _ = _pair(jb, tb)
    feed = _layer_feed(tm)
    grads = ["fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]
    want = jexe.run(jm, feed=feed, fetch_list=[jloss.name] + grads,
                    scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=[tloss.name] + grads,
                   scope=tscope)
    assert np.isfinite(float(got[0]))
    assert abs(float(got[0]) - float(want[0])) <= TOL * abs(float(want[0]))
    for n, g, w in zip(grads, got[1:], want[1:]):
        assert _rel_max(g, w) <= TOL, n


# --------------------------------------------------------------------------
# the book's programs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("narrow", [False, True], ids=["book", "narrow"])
@pytest.mark.parametrize("name", book.MODELS)
def test_book_program_is_op_for_op_the_jax_packages(name, narrow):
    cfg = book.NARROW[name] if narrow else {}
    jb = book.programs(name, jfluid, **cfg)
    tb = book.programs(name, tfluid, **cfg)
    assert step.signature(jb.main) == step.signature(tb.main)
    assert step.signature(jb.startup) == step.signature(tb.startup)
    assert tb.feeds == jb.feeds and tb.loss.name == jb.loss.name


def test_book_programs_at_the_books_widths():
    """The op counts and the parts the slice adds: the digits model's
    first conv is a depthwise_conv2d, every classifier's loss a
    cross_entropy, word2vec's four lookups share one sparse table."""
    types = {n: [op.type for op in
                 book.programs(n, tfluid).main.global_block().ops]
             for n in book.MODELS}
    assert {n: len(t) for n, t in types.items()} == {
        "fit_a_line": 13, "recognize_digits_conv": 39,
        "image_classification": 355, "word2vec": 33,
        "recommender_system": 74}
    assert types["recognize_digits_conv"].count("depthwise_conv2d") == 1
    for n in ("recognize_digits_conv", "image_classification", "word2vec"):
        assert types[n].count("cross_entropy") == 1, n
    w2v = book.programs("word2vec", tfluid).main.global_block()
    lookups = [op for op in w2v.ops if op.type == "lookup_table"]
    assert len(lookups) == 4 and {op.input("W")[0] for op in lookups} == \
        {"shared_w"} and all(op.attrs["is_sparse"] for op in lookups)
    assert w2v.var("shared_w").shape == (book.W2V_DICT, 32)
    assert types["word2vec"].count("lookup_table_grad") == 4
    assert types["word2vec"].count("sgd") == 5


def _feeds(name):
    cfg = book.NARROW[name]
    return [book.synthetic_batch(name, STEP_BATCH[name], seed=10 + k, **cfg)
            for k in range(STEPS)]


@pytest.mark.parametrize("name", book.MODELS)
def test_book_steps_in_lockstep_with_jax_executor(name):
    """STEPS steps, each from the JAX executor's state before it. Every op
    of the port's plan, run on the JAX step's values of its inputs
    (``replay``), within 1e-4 of its largest JAX output (the repo's op
    limit); the port's whole step: the loss within 1e-5 relative; the Adam
    models' parameters off by no more than the gradients' difference
    explains (``adam_param_misses``); and, in the models without a
    batch_norm, every gradient and every other persistable within 1e-5 of
    its largest JAX value. (A batch_norm's statistics round otherwise in
    the two packages, and its backward amplifies that: the depth-8
    ResNet's first conv gradient reads 0.5% apart, as in
    tests/test_torch_resnet.py, whose whole-step limits are looser.)"""
    cfg = book.NARROW[name]
    jb = book.programs(name, jfluid, **cfg)
    tb = book.programs(name, tfluid, **cfg)
    (jexe, jscope), (texe, tscope), state = _pair(jb, tb)
    block = tb.main.global_block()
    params = [p.name for p in tb.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params]
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    types = {op.type for op in block.ops}
    adam = "adam" in types
    for feed in _feeds(name):
        tfluid.params_from_numpy(state, tscope, "cpu")
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            jb.main, feed=feed, fetch_list=inter, scope=jscope))))
        after = {n: np.asarray(jscope.get(n)) for n in state}
        fetch = [tb.loss.name] + ([tb.acc.name] if tb.acc else [])
        errs = step.replay(tb.main, fetch, feed, state, after, vals)
        assert {t for t, _, _ in errs} >= types - {"fill_constant"}
        worst = max(errs, key=lambda e: e[2])
        assert worst[2] <= step.OP_TOL["float32"], worst
        got = texe.run(tb.main, feed=feed, fetch_list=[tb.loss.name] + grads,
                       scope=tscope)
        want = float(vals[tb.loss.name])
        assert abs(float(got[0]) - want) <= TOL * abs(want)
        got_after = {n: tscope.get(n) for n in state}
        if adam:
            misses = step.adam_param_misses(
                tb.main, state, got_after, after, dict(zip(grads, got[1:])),
                {g: vals[g] for g in grads})
            assert sorted(misses) == sorted(params)
            assert sum(misses.values()) == 0, misses
        if "batch_norm" not in types:
            for n, g in zip(grads, got[1:]):
                assert _rel_max(g, vals[n]) <= TOL, n
            for n in state:
                if not (adam and n in params):
                    assert _rel_max(got_after[n], after[n]) <= TOL, n
        state = after


@pytest.mark.parametrize("name", ["fit_a_line", "word2vec",
                                  "recommender_system"])
def test_sgd_book_models_run_steps_match_jax_executor(name):
    """The SGD models free-running: STEPS steps through run_steps on both
    executors from the same state, the losses within 1e-5 relative and
    every persistable within 1e-5 of its largest value."""
    cfg = book.NARROW[name]
    jb = book.programs(name, jfluid, **cfg)
    tb = book.programs(name, tfluid, **cfg)
    (jexe, jscope), (texe, tscope), state = _pair(jb, tb)
    feeds = _feeds(name)
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    want, = jexe.run_steps(jb.main, feed=stacked, n_steps=STEPS,
                           fetch_list=[jb.loss.name], scope=jscope)
    got, = texe.run_steps(tb.main, feed=stacked, n_steps=STEPS,
                          fetch_list=[tb.loss.name], scope=tscope)
    assert got.shape == (STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL)
    for n in state:
        assert _rel_max(tscope.get(n), jscope.get(n)) <= TOL, n


@pytest.mark.parametrize("name", ["recognize_digits_conv", "word2vec"])
def test_book_model_saved_and_served(name, tmp_path):
    """One step, then save_inference_model (the prediction from the feeds
    but the label); the port and the JAX package load the artifact and
    serve a batch: the same predictions, which are the trained program's
    in test mode."""
    cfg = book.NARROW[name]
    tb = book.programs(name, tfluid, **cfg)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tb.startup, scope=scope)
    exe.run(tb.main, feed=book.synthetic_batch(name, 16, seed=1, **cfg),
            fetch_list=[tb.loss], scope=scope)
    inputs = tb.feeds[:-1] if name == "word2vec" else tb.feeds[:1]
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(str(tmp_path), inputs, [tb.predict],
                                       exe, main_program=tb.main)
    feed = {k: v for k, v in book.synthetic_batch(name, 8, seed=2,
                                                  **cfg).items()
            if k in inputs}
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, _ = tfluid.io.load_inference_model(str(tmp_path), exe)
        assert feeds == inputs
        got, = exe.run(prog, feed=feed)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, _, _ = jfluid.io.load_inference_model(str(tmp_path), jexe)
        want, = jexe.run(jprog, feed=feed)
    want = np.asarray(want)
    assert got.shape == want.shape == (8, 10 if name != "word2vec" else
                                       cfg["dict_size"])
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    assert _rel_max(got, want) <= TOL
