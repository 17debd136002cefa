"""The port's fluid.inference and fluid.transpiler against the JAX
package's, on the CPU.

- The predictor round trip of tests/test_inference.py, on the CPU
  (``use_gpu = False``); the default config asks for the card, which this
  machine lacks, and ``export_stablehlo`` raises.
- InferenceTranspiler: after the same transpile of the same scope values,
  the port's folded filters and biases are bit for bit the JAX
  transpiler's (both fold in numpy float32 on the host) and the two op
  lists are equal, for conv without a bias, conv with a bias and
  ResNet-cifar10 of depth 8; the folded program's output stays within 2e-4
  of the unfolded one's (tests/test_inference_transpiler.py's bound), in
  the same Executor (the transpile bumps the program's version).
- The is_test pass; memory_optimize is a no-op that warns.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid.inference import (AnalysisConfig, NativeConfig,
                                              create_paddle_predictor)
from paddle_tpu_torch.models import resnet as tresnet


@pytest.fixture(autouse=True)
def _no_staging_debris():
    yield
    assert tio._live_export_staging() == []


def _cpu():
    return tfluid.Executor(tfluid.CPUPlace())


def _save_mlp(model_dir):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        pred = tfluid.layers.fc(input=h, size=3, act="softmax")
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                       main_program=main)
    xin = np.random.RandomState(0).rand(5, 6).astype("float32")
    ref, = exe.run(main, feed={"x": xin}, fetch_list=[pred], scope=scope)
    return xin, ref


def test_predictor_roundtrip(tmp_path):
    model_dir = str(tmp_path / "model")
    xin, ref = _save_mlp(model_dir)
    config = AnalysisConfig(model_dir)
    config.use_gpu = False
    predictor = create_paddle_predictor(config)
    assert predictor.exe.device.type == "cpu"
    out = predictor.run({"x": xin})
    np.testing.assert_array_equal(out[0], ref)
    assert predictor.run([xin])[0].shape == (5, 3)
    # a new batch size runs without a rebuild
    out2 = predictor.run({"x": np.random.rand(2, 6).astype("float32")})
    assert out2[0].shape == (2, 3)
    np.testing.assert_allclose(out2[0].sum(1), np.ones(2), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 11"):
        predictor.export_stablehlo({"x": xin})


def test_predictor_asks_for_the_card_by_default(tmp_path):
    model_dir = str(tmp_path / "model")
    _save_mlp(model_dir)
    assert NativeConfig().use_gpu is True
    with pytest.raises(RuntimeError, match="CUDA card"):
        create_paddle_predictor(AnalysisConfig(model_dir))


def _conv_bn(fluid, with_bias):
    """tests/test_inference_transpiler.py's model (its relu as the batch
    norm's act)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   padding=1, bias_attr=with_bias or False)
        out = fluid.layers.batch_norm(conv, act="relu", is_test=True)
    return main, startup, out


def _resnet(fluid):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        m = jresnet if fluid is jfluid else tresnet
        _, loss, _ = m.build(dataset="cifar10", depth=8, is_test=True)
    block = main.global_block()
    op = [o for o in block.ops if o.type == "softmax_with_cross_entropy"][0]
    return main, startup, block.var(op.input("Logits")[0])


MODELS = {
    "conv_no_bias": lambda fluid: _conv_bn(fluid, False),
    "conv_with_bias": lambda fluid: _conv_bn(fluid, True),
    "resnet_cifar10_8": _resnet,
}


def _state(main, scope, port):
    return {v.name: (scope.get(v.name).float().numpy() if port
                     else np.asarray(scope.get(v.name), "float32"))
            for v in main.list_vars()
            if v.persistable and scope.get(v.name) is not None}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fold_is_bit_for_bit_the_jax_transpilers(name):
    jmain, jstartup, jout = MODELS[name](jfluid)
    tmain, tstartup, tout = MODELS[name](tfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    # running statistics and scales away from their initial values
    rng = np.random.RandomState(7)
    for v in jmain.list_vars():
        if v.persistable and v.name.startswith("batch_norm"):
            lo = 0.5 if v.name.endswith((".w_0", ".w_2")) else -0.5
            jscope.set(v.name, rng.uniform(lo, 1.5, v.shape).astype("float32"))
        elif v.persistable and v.name.startswith("conv2d") and \
                v.name.endswith(".b_0"):
            jscope.set(v.name, rng.randn(*v.shape).astype("float32"))
    texe, tscope = _cpu(), tfluid.Scope()
    texe.run(tstartup, scope=tscope)
    tfluid.params_from_numpy(_state(jmain, jscope, port=False), tscope, "cpu")
    shape = [3, 3, 8, 8] if name.startswith("conv") else [3, 3, 32, 32]
    x = {"img": rng.rand(*shape).astype("float32")}
    before, = texe.run(tmain, feed=x, fetch_list=[tout], scope=tscope)
    version = tmain.version

    with jfluid.scope_guard(jscope):
        jfluid.transpiler.InferenceTranspiler().transpile(
            jmain, jfluid.CPUPlace(), scope=jscope)
    tfluid.transpiler.InferenceTranspiler().transpile(
        tmain, tfluid.CPUPlace(), scope=tscope)
    assert tmain.version > version
    jops = [(op.type, dict(op.inputs), dict(op.outputs))
            for op in jmain.global_block().ops]
    assert [(op.type, dict(op.inputs), dict(op.outputs))
            for op in tmain.global_block().ops] == jops
    assert "batch_norm" not in [op[0] for op in jops]
    assert list(tmain.global_block().vars) == list(jmain.global_block().vars)
    jstate, tstate = _state(jmain, jscope, False), _state(tmain, tscope, True)
    folded = [n for n in jstate if n.endswith(("fused_bn_bias", ".b_0")) or
              n.startswith("conv2d")]
    assert folded
    for n in folded:
        np.testing.assert_array_equal(tstate[n], jstate[n], err_msg=n)
        assert tscope.get(n).dtype == tfluid.core_types.to_torch_dtype(
            tmain.global_block().var(n).dtype)

    # the same Executor plans the transpiled program anew
    after, = texe.run(tmain, feed=x, fetch_list=[tout], scope=tscope)
    assert np.abs(after - before).max() <= 2e-4 * np.abs(before).max()


def test_is_test_pass_sets_dropout():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        d = tfluid.layers.dropout(x, dropout_prob=0.5)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((64, 4), "float32")}
    dropped, = exe.run(main, feed=feed, fetch_list=[d], scope=scope)
    assert (dropped == 0).any()
    tfluid.transpiler.InferenceTranspiler().transpile(
        main, tfluid.CPUPlace(), scope=scope)
    (drop,) = [op for op in main.global_block().ops if op.type == "dropout"]
    assert drop.attrs["is_test"] is True
    kept, = exe.run(main, feed=feed, fetch_list=[d], scope=scope)
    assert not (kept == 0).any()


def test_memory_optimize_warns_and_returns_none(monkeypatch):
    monkeypatch.setattr(tflags, "_warned", set())
    with pytest.warns(UserWarning, match="no-op.*last reader"):
        assert tfluid.memory_optimize(tfluid.Program()) is None
    assert tfluid.release_memory(tfluid.Program()) is None
