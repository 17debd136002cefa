"""The compression surface on the port against the JAX package, on the CPU:
``fluid.contrib``'s QuantizeTranspiler, the int8 Calibrator and slim
(pruning, distillation, the Compressor), ``Program._dist_attrs``,
``Scope.erase``, ``layers.chunk_eval`` / ``layers.hash`` and both
ChunkEvaluators.

- Programs op for op (the transpiled QAT programs, the converted int8
  program, the merged distillation program, the layers' ops).
- Values: a QAT net's losses over 10 Adam steps within 1e-5; the int8
  weights and the pruning masks exactly; every scale, range and loss
  within 1e-6 relative.
- The evaluators' states, ``eval`` and ``reset`` equal over several
  batches; ``metrics.ChunkEvaluator`` fed the op's counts.
- Each difference from the Paddle reference that the two packages share
  is pinned by a test named ``..._in_both_packages`` (ROADMAP Queue 3).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

BOTH = [jfluid, tfluid]
IDS = ["jax", "port"]


def _as_np(fluid, v):
    return fluid.executor.as_numpy(v) if fluid is tfluid else np.asarray(v)


def _exe(fluid):
    return fluid.Executor(fluid.CPUPlace())


def _fc_net(fluid, quant=None, optimizer=True, seed=5):
    """Two fc layers over 16 features, 4 classes; `quant` the transpiler's
    keywords (training_transpile before minimize)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        if quant is not None:
            fluid.contrib.QuantizeTranspiler(**quant).training_transpile(
                main)
        if optimizer:
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, logits


def _conv_net(fluid, quant):
    """conv2d, depthwise_conv2d and fc, QAT-transpiled."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                act="relu")
        d = fluid.layers.conv2d(c, num_filters=4, filter_size=3, groups=4,
                                use_cudnn=False)
        out = fluid.layers.fc(input=[d, d], size=3)
        loss = fluid.layers.mean(out)
        fluid.contrib.QuantizeTranspiler(**quant).training_transpile(main)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(seed=0, n=16):
    r = np.random.RandomState(seed)
    return {"x": r.rand(n, 16).astype("float32"),
            "y": r.randint(0, 4, (n, 1)).astype("int64")}


def _state(fluid, main, startup):
    """The persistables after the port's startup, as numpy."""
    scope = tfluid.Scope()
    _exe(tfluid).run(startup, scope=scope)
    return {n: tfluid.executor.as_numpy(scope.get(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.get(n) is not None}


def _scope(fluid, state, program=None, startup=None):
    """A scope of `fluid` holding `state` (the port's after its startup)."""
    scope = fluid.Scope()
    if fluid is tfluid:
        _exe(tfluid).run(startup, scope=scope)
        for n, v in state.items():
            if scope.get(n) is None:     # not the startup's (a teacher's)
                scope.set(n, torch.from_numpy(v.copy()))
        tfluid.params_from_numpy(state, scope, "cpu")
    else:
        for n, v in state.items():
            scope.set(n, v)
    return scope


QUANT = [dict(weight_bits=8, activation_bits=8),
         dict(weight_bits=4, activation_bits=6),
         dict(activation_quantize_type="moving_average_abs_max"),
         dict(activation_quantize_type="range_abs_max",
              weight_quantize_type="range_abs_max")]


@pytest.mark.parametrize("quant", QUANT, ids=["8", "4_6", "moving_average",
                                              "range"])
@pytest.mark.parametrize("net", ["fc", "conv"])
def test_training_transpile_is_op_for_op_the_jax_packages(net, quant):
    build = _fc_net if net == "fc" else _conv_net
    j, t = build(jfluid, quant), build(tfluid, quant)
    assert step.signature(j[0]) == step.signature(t[0])
    assert step.signature(j[1]) == step.signature(t[1])
    types = [op.type for op in t[0].global_block().ops]
    assert types.count("ste_identity_grad") >= 4


def test_qat_steps_match_the_jax_executor():
    """tests/test_contrib_and_bert.py's QAT net: 10 Adam steps from the
    same start, each loss within 1e-5, and falling."""
    quant = dict(weight_bits=8, activation_bits=8)
    j, t = _fc_net(jfluid, quant), _fc_net(tfluid, quant)
    state = _state(tfluid, t[0], t[1])
    jscope, tscope = _scope(jfluid, state), _scope(tfluid, state, *t[:2])
    feed = _feed()
    losses = []
    for _ in range(10):
        want = float(np.asarray(_exe(jfluid).run(
            j[0], feed=feed, fetch_list=[j[2]], scope=jscope)[0]))
        got = float(_exe(tfluid).run(t[0], feed=feed, fetch_list=[t[2]],
                                     scope=tscope)[0])
        assert abs(got - want) <= 1e-5 * abs(want)
        losses.append(got)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
@pytest.mark.parametrize("act_type", ["moving_average_abs_max",
                                      "range_abs_max"])
def test_stateful_quantizers_transpiled_raise_in_both_packages(fluid,
                                                               act_type):
    """training_transpile passes these types no InScale state, so the
    program raises at its first run (the reference creates the state;
    ROADMAP Queue 3)."""
    main, startup, loss, _ = _fc_net(
        fluid, dict(activation_quantize_type=act_type))
    exe = _exe(fluid)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(AttributeError, match="NoneType"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_freeze_program_only_clones_for_test_in_both_packages(fluid):
    """freeze_program folds nothing: it is clone(for_test=True), the round
    trips still in (the reference rewrites them to int8 ops; ROADMAP
    Queue 3)."""
    main = _fc_net(fluid, dict(weight_bits=8, activation_bits=8))[0]
    frozen = fluid.contrib.QuantizeTranspiler().freeze_program(main)
    assert step.signature(frozen) == \
        step.signature(main.clone(for_test=True))
    assert sum(op.type == "fake_quantize_dequantize_abs_max"
               for op in frozen.global_block().ops) == 4
    assert frozen._is_test


def _trained(fluid, state, t_prog, steps=3):
    """The fc net trained `steps` Adam steps in `fluid` from `state`:
    (its test program, the scope)."""
    main, startup, loss, logits = _fc_net(fluid, dict(weight_bits=8,
                                                      activation_bits=8))
    scope = _scope(fluid, state, main, startup)
    for k in range(steps):
        _exe(fluid).run(main, feed=_feed(k), fetch_list=[loss],
                        scope=scope)
    test = main.clone(for_test=True)._prune(["x"], [logits.name])
    return test, scope, logits


def test_convert_to_int8_matches_jax():
    """From one state: the converted names, the int8 weights exactly, the
    scale attrs, the program op for op, W erased from the scope and
    non-persistable; the converted program's logits."""
    t0 = _fc_net(tfluid, dict(weight_bits=8, activation_bits=8))
    state = _state(tfluid, *t0[:2])
    out = {}
    for fluid in BOTH:
        test, scope, logits = _trained(fluid, state, t0)
        before = _exe(fluid).run(test, feed={"x": _feed(9)["x"]},
                                 fetch_list=[logits.name], scope=scope)[0]
        names = fluid.contrib.QuantizeTranspiler().convert_to_int8(
            test, scope=scope)
        after = _exe(fluid).run(test, feed={"x": _feed(9)["x"]},
                                fetch_list=[logits.name], scope=scope)[0]
        out[fluid] = (names, test, {n: _as_np(fluid, scope.get(n + "@INT8"))
                                    for n in names}, np.asarray(before),
                      np.asarray(after), scope)
    jn, jt, jq, jb, ja, _ = out[jfluid]
    tn, tt, tq, tb, ta, tscope = out[tfluid]
    assert tn == jn == ["fc_0.w_0", "fc_1.w_0"]
    assert step.signature(tt) == step.signature(jt)
    for n in jn:
        assert tq[n].dtype == np.int8
        np.testing.assert_array_equal(tq[n], jq[n])
        assert np.abs(tq[n]).max() == 127
        assert tscope.get(n) is None
        assert not tt.global_block().var(n).persistable
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)
    # the int8 weights move the logits by their rounding alone
    assert np.abs(ta - tb).max() <= 0.05 * np.abs(tb).max()


def _calibrator(fluid, state, t0, algo, dirname=None):
    test, scope, logits = _trained(fluid, state, t0)
    cal = fluid.contrib.Calibrator(
        program=test, exe=_exe(fluid), feed_var_names=["x"],
        fetch_list=[test.global_block().var(logits.name)], scope=scope,
        algo=algo)
    for k in range(2):
        cal.sample_data({"x": _feed(20 + k)["x"]})
    with fluid.scope_guard(scope):
        prog = cal.save_int8_model(dirname)
    return cal, prog


def test_calibrator_matches_jax_and_ignores_algo_in_both_packages(
        tmp_path):
    """The sampled outputs in op order, their ranges, the int8_scales in
    _dist_attrs: the JAX package's; and the same with algo "direct" as
    with "KL" (both take the running max |x|; ROADMAP Queue 3)."""
    t0 = _fc_net(tfluid, dict(weight_bits=8, activation_bits=8))
    state = _state(tfluid, *t0[:2])
    scales = {}
    for fluid in BOTH:
        for algo in ("KL", "direct"):
            cal, prog = _calibrator(fluid, state, t0, algo)
            scales[fluid, algo] = (list(cal._ranges),
                                   prog._dist_attrs["int8_scales"])
    for fluid in BOTH:
        assert scales[fluid, "KL"] == scales[fluid, "direct"]
    (jn, js), (tn, ts) = scales[jfluid, "KL"], scales[tfluid, "KL"]
    assert tn == jn and set(ts) == set(js) == set(jn)
    for n in js:
        assert abs(ts[n] - js[n]) <= 1e-6 * js[n], n


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_int8_scales_are_not_saved_with_the_model_in_both_packages(
        fluid, tmp_path):
    """The Calibrator keeps its scales in _dist_attrs, which the model
    file (framework.proto) does not carry: the loaded int8 model has none
    (the reference writes them into its quantize ops; ROADMAP Queue 3).
    Its int8 weights load as int8."""
    t0 = _fc_net(tfluid, dict(weight_bits=8, activation_bits=8))
    state = _state(tfluid, *t0[:2])
    _, prog = _calibrator(fluid, state, t0, "KL", str(tmp_path))
    assert prog._dist_attrs["int8_scales"]
    with fluid.scope_guard(fluid.Scope()):
        loaded, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path), _exe(fluid))
        assert "int8_scales" not in loaded._dist_attrs
        w = fluid.global_scope().get("fc_0.w_0@INT8")
        assert str(w.dtype).endswith("int8")
    assert feeds == ["x"]


def test_dist_attrs_serialize_and_clone_as_in_jax():
    for fluid in BOTH:
        p = fluid.Program()
        assert p._dist_attrs == {}
        p._dist_attrs["int8_scales"] = {"a": 0.5}
        d = p.to_dict()
        assert d["dist_attrs"] == {"int8_scales": {"a": 0.5}}
        assert fluid.Program.from_dict(d)._dist_attrs == p._dist_attrs
        assert p.clone()._dist_attrs == p._dist_attrs
        assert fluid.Program.parse_from_string(
            p.serialize_to_json())._dist_attrs == p._dist_attrs


def test_scope_erase_drops_values():
    for fluid in BOTH:
        scope = fluid.Scope()
        scope.set("a", np.ones(2, np.float32) if fluid is jfluid
                  else torch.ones(2))
        scope.erase(["a", "missing"])
        assert scope.get("a") is None


# ---- slim ------------------------------------------------------------------

def _regression(fluid, seed=61):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu",
                            param_attr=fluid.ParamAttr(name="pw1"))
        out = fluid.layers.fc(input=h, size=1,
                              param_attr=fluid.ParamAttr(name="pw2"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(out, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    r = np.random.RandomState(1)
    xv = r.rand(64, 16).astype("float32")
    return main, startup, loss, {"x": xv, "y": (xv.sum(1, keepdims=True) *
                                                0.1).astype("float32")}


def test_pruning_matches_jax():
    """test_slim.py's run in both packages from one state: the masks
    exactly, the sparsity, the pruned weights kept at 0 and the trained
    ones within 1e-6 over 10 masked steps."""
    t = _regression(tfluid)
    state = _state(tfluid, *t[:2])
    runs = {}
    for fluid in BOTH:
        main, startup, loss, feed = _regression(fluid)
        scope = _scope(fluid, state, main, startup)
        with fluid.scope_guard(scope):
            masks = fluid.contrib.slim.prune_parameters(main, scope, 0.5)
            losses = []
            for _ in range(10):
                losses.append(float(np.asarray(_exe(fluid).run(
                    main, feed=feed, fetch_list=[loss])[0]).reshape(())))
                fluid.contrib.slim.apply_masks(scope, masks)
        runs[fluid] = (masks, fluid.contrib.slim.sparsity(scope, masks),
                       _as_np(fluid, scope.get("pw1")), losses)
    (jm, js, jw, jl), (tm, ts, tw, tl) = runs[jfluid], runs[tfluid]
    assert set(tm) == set(jm) == {"pw1", "pw2"}
    for n in jm:
        np.testing.assert_array_equal(tm[n], jm[n])
    assert ts == js and abs(ts - 0.5) < 0.05
    assert (tw[jm["pw1"] == 0] == 0).all()
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]


def test_prune_strategy_ramps_as_in_jax():
    for fluid in BOTH:
        s = fluid.contrib.slim.PruneStrategy(start_epoch=1, end_epoch=4,
                                             target_ratio=0.6)
        assert [round(s._ratio_at(e), 6) for e in range(1, 6)] == \
            [0.2, 0.4, 0.6, 0.6, 0.6]


def _teacher_student(fluid):
    t_main, t_start = fluid.Program(), fluid.Program()
    t_start.random_seed = 62
    with fluid.program_guard(t_main, t_start), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        t_logits = fluid.layers.fc(
            input=fluid.layers.fc(input=x, size=32, act="relu",
                                  param_attr=fluid.ParamAttr(name="tw1")),
            size=4, param_attr=fluid.ParamAttr(name="tw2"))
    s_main, s_start = fluid.Program(), fluid.Program()
    s_start.random_seed = 63
    with fluid.program_guard(s_main, s_start), fluid.unique_name.guard():
        xs = fluid.layers.data(name="x", shape=[8], dtype="float32")
        s_logits = fluid.layers.fc(input=xs, size=4,
                                   param_attr=fluid.ParamAttr(name="sw"))
    return t_main, t_start, t_logits, s_main, s_start, s_logits


def test_distillation_matches_jax():
    """test_slim.py's merge and soft-label distillation in both packages:
    the merged program op for op, the teacher's vars frozen (no optimizer
    op updates one), the teacher's values copied by merge(scope=...), and
    25 SGD steps' losses within 1e-6 relative."""
    runs = {}
    for fluid in BOTH:
        t_main, t_start, t_logits, s_main, s_start, s_logits = \
            _teacher_student(fluid)
        tscope = fluid.Scope()
        _exe(fluid).run(t_start, scope=tscope)
        rename = fluid.contrib.slim.merge(t_main, s_main,
                                          data_name_map={"x": "x"},
                                          scope=tscope)
        for tname, mname in rename.items():
            if tname != "x":
                np.testing.assert_array_equal(
                    _as_np(fluid, tscope.get(mname)),
                    _as_np(fluid, tscope.get(tname)))
        with fluid.program_guard(s_main, s_start), \
                fluid.unique_name.guard():
            t_out = s_main.global_block().var(rename[t_logits.name])
            loss = fluid.contrib.slim.soft_label_loss(t_out, s_logits)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        runs[fluid] = (s_main, s_start, rename, loss, tscope)
    (jm, js, jr, jl, jt), (tm, ts, tr, tl, tt) = runs[jfluid], runs[tfluid]
    assert tr == jr
    assert step.signature(tm) == step.signature(jm)
    block = tm.global_block()
    for n in tr.values():
        if n != "x":
            assert block.var(n).stop_gradient
    assert not any(op.attrs.get("op_role_var", [""])[0].startswith(
        "teacher_") for op in block.ops if op.attrs.get("op_role_var"))
    state = _state(tfluid, tm, ts)
    state.update({m: tfluid.executor.as_numpy(tt.get(m))
                  for n, m in tr.items() if tt.get(m) is not None})
    xv = np.random.RandomState(2).rand(32, 8).astype("float32")
    losses = {}
    for fluid, (main, start, _, loss, _) in runs.items():
        scope = _scope(fluid, state, main, start)
        losses[fluid] = [float(np.asarray(_exe(fluid).run(
            main, feed={"x": xv}, fetch_list=[loss], scope=scope)[0])
            .reshape(())) for _ in range(25)]
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=1e-6)
    assert losses[tfluid][-1] < losses[tfluid][0]


@pytest.mark.parametrize("loss", ["fsp_loss", "l2_loss", "soft_label_loss"])
def test_distillation_losses_match_jax(loss):
    r = np.random.RandomState(7)
    feed = {k: r.randn(2, 3, 4, 4).astype("float32")
            for k in ("a", "b", "c", "d")}
    out = {}
    for fluid in BOTH:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            v = {k: fluid.layers.data(name=k, shape=[3, 4, 4],
                                      dtype="float32") for k in feed}
            fn = getattr(fluid.contrib.slim, loss)
            if loss == "fsp_loss":
                y = fn(v["a"], v["b"], v["c"], v["d"])
            else:
                y = fn(fluid.layers.reshape(v["a"], [2, 48]),
                       fluid.layers.reshape(v["c"], [2, 48]))
        out[fluid] = (step.signature(main), float(np.asarray(_exe(fluid).run(
            main, feed=feed, fetch_list=[y], scope=fluid.Scope())[0])
            .reshape(())))
    assert out[tfluid][0] == out[jfluid][0]
    assert abs(out[tfluid][1] - out[jfluid][1]) <= 1e-6 * abs(out[jfluid][1])


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_merge_refuses_a_teacher_with_sub_blocks(fluid):
    t_main = fluid.Program()
    t_main.create_block()
    t_main.rollback()
    with pytest.raises(NotImplementedError, match="sub-blocks"):
        fluid.contrib.slim.merge(t_main, fluid.Program())


def test_compressor_matches_jax():
    """test_slim.py's Compressor run with PruneStrategy (two epochs, one
    batch each), and a run with no strategy, which QAT-transpiles and
    returns the frozen program: both as the JAX package's."""
    runs = {}
    t = _regression(tfluid, seed=64)
    state = _state(tfluid, *t[:2])
    for fluid in BOTH:
        main, startup, loss, feed = _regression(fluid, seed=64)
        scope = _scope(fluid, state, main, startup)
        strat = fluid.contrib.slim.PruneStrategy(target_ratio=0.5)
        comp = fluid.contrib.slim.Compressor(
            fluid.CPUPlace(), scope, main, train_reader=lambda: iter([feed]),
            train_feed_list=["x", "y"], train_fetch_list=[loss])
        comp.epoch = 2
        comp.strategies = [strat]
        final = comp.run()
        quant_main = _regression(fluid, seed=64)[0]
        frozen = fluid.contrib.slim.Compressor(
            fluid.CPUPlace(), fluid.Scope(), quant_main).run()
        runs[fluid] = (strat.masks, _as_np(fluid, scope.get("pw1")),
                       step.signature(final), step.signature(frozen),
                       frozen)
    (jm, jw, jf, jq, _), (tm, tw, tf_, tq, frozen) = runs[jfluid], \
        runs[tfluid]
    for n in jm:
        np.testing.assert_array_equal(tm[n], jm[n])
    assert (tw[jm["pw1"] == 0] == 0).all()
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    assert tf_ == jf and tq == jq
    assert frozen._is_test and any(
        op.type == "fake_quantize_dequantize_abs_max"
        for op in frozen.global_block().ops)


def test_compressor_config_reads_a_dict_and_a_json_file(tmp_path):
    cfg = {"compressor": {"epoch": 3, "strategies": ["prune"]}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    for fluid in BOTH:
        for source in (cfg, str(path)):
            # a file: YAML where yaml imports (JSON text is YAML), else JSON
            c = fluid.contrib.slim.Compressor(None, None, None)
            c.config(source)
            assert c.epoch == 3 and c.strategies == ["prune"]


# ---- chunk evaluation and hashing ------------------------------------------

def _chunk_program(fluid, types=3, scheme="IOB"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        inf = fluid.layers.data(name="inf", shape=[-1, 12], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, 12], dtype="int64",
                                append_batch_size=False)
        ev = fluid.evaluator.ChunkEvaluator(inf, lab, scheme, types)
        counts = fluid.layers.chunk_eval(inf, lab, scheme, types)
    return main, startup, ev, counts


def _tags(seed, b=5, t=12, high=7, agree=None):
    r = np.random.RandomState(seed)
    tags = r.randint(0, high, (b, t)).astype(np.int64)
    if agree is not None:
        tags = np.where(r.rand(b, t) < 0.25, tags, agree)
    return tags


def test_both_chunk_evaluators_match_jax_over_batches():
    """evaluator.ChunkEvaluator's states after each of 4 batches, its eval
    and reset, the layer's six outputs, and metrics.ChunkEvaluator fed
    the layer's counts: the JAX package's."""
    runs = {}
    for fluid in BOTH:
        main, startup, ev, counts = _chunk_program(fluid)
        exe = _exe(fluid)
        metric = fluid.metrics.ChunkEvaluator()
        out = []
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            for k in range(4):
                if k == 2:
                    ev.reset(exe)
                    metric.reset()
                lab = _tags(k)
                got = exe.run(main, feed={"lab": lab,
                                          "inf": _tags(k + 10, agree=lab)},
                              fetch_list=list(ev.metrics) + list(counts))
                metric.update(*got[-3:])
                out.append(([np.asarray(g).tolist() for g in got],
                            [float(np.asarray(_as_np(fluid, fluid
                                                     .global_scope()
                                                     .get(v.name))).sum())
                             for v in ev.states],
                            [float(v[0]) for v in ev.eval(exe)],
                            metric.eval()))
        runs[fluid] = (step.signature(main), out)
    assert runs[tfluid][0] == runs[jfluid][0]
    for (tg, ts, te, tm), (jg, js, je, jm) in zip(runs[tfluid][1],
                                                  runs[jfluid][1]):
        np.testing.assert_allclose(np.concatenate(tg), np.concatenate(jg),
                                   rtol=1e-6)
        assert ts == js and tm == jm
        np.testing.assert_allclose(te, je, rtol=1e-6)
    assert 0 < runs[tfluid][1][-1][2][2] < 1


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_chunk_eval_scores_a_padded_tail_in_both_packages(fluid):
    """The layer passes no Length: a row padded with id 0 (a B- tag of type
    0 in IOB) after its end scores each pad as a one-token chunk (the
    reference reads the LoD; ROADMAP Queue 3)."""
    main, startup, _, counts = _chunk_program(fluid)
    tags = np.full((1, 12), 6, np.int64)        # 6 = O at 3 types
    tags[0, :3] = [0, 1, 6]                      # one chunk, then O
    padded = tags.copy()
    padded[0, 8:] = 0                            # a pad of 4 after the end
    exe = _exe(fluid)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        clean = exe.run(main, feed={"inf": tags, "lab": tags},
                        fetch_list=list(counts[3:]))
        pad = exe.run(main, feed={"inf": padded, "lab": padded},
                      fetch_list=list(counts[3:]))
    assert [int(np.asarray(v)[0]) for v in clean] == [1, 1, 1]
    assert [int(np.asarray(v)[0]) for v in pad] == [5, 5, 5]


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_chunk_eval_of_2d_tags_against_a_3d_label_raises_in_both_packages(
        fluid):
    """chunk_eval squeezes its Label only when its Inference is 3-D:
    crf_decoding's [B, T] tags against a [B, T, 1] target raise (the
    reference's LoD tensors are [N, 1] both; ROADMAP Queue 3)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        inf = fluid.layers.data(name="inf", shape=[-1, 12], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, 12, 1],
                                dtype="int64", append_batch_size=False)
        out = fluid.layers.chunk_eval(inf, lab, "IOB", 3)
    with pytest.raises(Exception, match="shape|Shape|broadcast|dimension"):
        _exe(fluid).run(main, feed={"inf": _tags(0),
                                    "lab": _tags(0)[..., None]},
                        fetch_list=[out[0]], scope=fluid.Scope())


def _knuth_hash(x, num_hash, mod_by):
    """The JAX lowering's mixer in numpy uint32 (not xxHash)."""
    flat = x.reshape(x.shape[0], -1).astype(np.uint32)
    salt = (np.arange(flat.shape[1], dtype=np.uint32) + 1) * \
        np.uint32(0x85EBCA6B)
    outs = []
    with np.errstate(over="ignore"):
        for i in range(num_hash):
            m = flat * np.uint32(2654435761) + \
                np.uint32((0x9E3779B9 * (i + 1)) & 0xFFFFFFFF)
            m = m ^ (m >> np.uint32(16))
            m = (m ^ salt) * np.uint32(0xC2B2AE35)
            outs.append(m.sum(axis=1, dtype=np.uint32) % np.uint32(mod_by))
    return np.stack(outs, 1).astype(np.int64)[..., None]


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_hash_is_a_knuth_mixer_not_xxhash_in_both_packages(fluid):
    """layers.hash gives the Knuth multiplicative mixer with a position
    salt, computed here in numpy uint32, where the reference gives xxHash
    (ROADMAP Queue 3)."""
    ids = np.random.RandomState(3).randint(0, 2 ** 31, (64, 26)).astype(
        np.int64)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="ids", shape=[26], dtype="int64")
        out = fluid.layers.hash(x, hash_size=100000, num_hash=2)
    got = _exe(fluid).run(main, feed={"ids": ids}, fetch_list=[out],
                          scope=fluid.Scope())[0]
    np.testing.assert_array_equal(np.asarray(got),
                                  _knuth_hash(ids, 2, 100000))


def test_layers_hash_and_chunk_eval_are_op_for_op_the_jax_packages():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="ids", shape=[26], dtype="int64")
            fluid.layers.hash(x, hash_size=1000, num_hash=3)
            inf = fluid.layers.data(name="inf", shape=[20, 1],
                                    dtype="int64")
            fluid.layers.chunk_eval(inf, inf, "IOBES", 4,
                                    excluded_chunk_types=[2])
        return main
    assert step.signature(build(tfluid)) == step.signature(build(jfluid))
    assert {"hash", "chunk_eval"} <= set(tfluid.layers.nn.__all__)


@pytest.mark.parametrize("fluid", BOTH, ids=IDS)
def test_lookup_sparse_table_clips_and_grows_no_row_in_both_packages(fluid):
    """An id past the table reads its last row (a negative id its first),
    and the table keeps its size (the reference grows it with zero rows;
    ROADMAP Queue 3)."""
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        table = fluid.layers.data(name="w", shape=[6, 2], dtype="float32",
                                  append_batch_size=False)
        ids = fluid.layers.data(name="ids", shape=[4, 1], dtype="int64",
                                append_batch_size=False)
        helper = fluid.layer_helper.LayerHelper("lookup_sparse_table")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="lookup_sparse_table",
                         inputs={"W": [table], "Ids": [ids]},
                         outputs={"Out": [out]})
    got = _exe(fluid).run(main, feed={"w": w, "ids": np.array(
        [[1], [6], [100], [-2]], np.int64)}, fetch_list=[out],
        scope=fluid.Scope())[0]
    np.testing.assert_array_equal(np.asarray(got), w[[1, 5, 5, 0]])
