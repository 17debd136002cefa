"""The port's Executor (paddle_tpu_torch.fluid.executor) on the CPU: places,
feeds, the run plan (only needed ops run; intermediates dropped after their
last reader), startup initializers, and parameter interop with the JAX
package. Small programs; inputs from a seeded numpy RNG."""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import transformer


def _mlp(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        h = fl.layers.fc(input=x, size=5, act="relu")
        y = fl.layers.fc(input=h, size=3)
        out = fl.layers.mean(fl.layers.scale(y, scale=0.5, bias=1.0))
    return main, startup, h, y, out


def test_executor_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError):
        fluid.Executor(fluid.CUDAPlace(0))
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    assert fluid.CUDAPlace(1).torch_device() == torch.device("cuda", 1)


def test_mlp_matches_jax_executor():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype("float32")
    jm, js, _, _, jout = _mlp(jfluid)
    tm, ts, _, _, tout = _mlp(fluid)
    jscope, tscope = jfluid.Scope(), fluid.Scope()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    fluid.params_from_numpy({p.name: np.asarray(jscope.get(p.name))
                             for p in jm.all_parameters()}, tscope, "cpu")
    want, = jexe.run(jm, feed={"x": x}, fetch_list=[jout], scope=jscope)
    got, = texe.run(tm, feed={"x": x}, fetch_list=[tout], scope=tscope)
    assert got.shape == np.asarray(want).shape == ()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plan_runs_only_needed_ops_and_drops_dead_values():
    main, startup, h, y, out = _mlp(fluid)
    plan = texecutor._Plan(main, [h.name])
    assert [op.type for op, _ in plan.steps] == ["mul", "elementwise_add",
                                                 "relu"]
    # every value is dropped after its last reader, the fetch is kept
    for fetch in ([h.name], [out.name]):
        plan = texecutor._Plan(main, fetch)
        live = set()
        for i, (op, drop) in enumerate(plan.steps):
            live |= set(op.input_arg_names) | set(op.output_arg_names)
            later = {n for o, _ in plan.steps[i + 1:]
                     for n in o.input_arg_names}
            assert not set(drop) & later
            live -= set(drop)
        assert live == set(fetch)

    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    x = np.random.RandomState(1).randn(3, 6).astype("float32")
    hv, = exe.run(main, feed={"x": x}, fetch_list=[h], scope=scope)
    w = scope.get("fc_0.w_0").numpy()
    b = scope.get("fc_0.b_0").numpy()
    np.testing.assert_allclose(hv, np.maximum(x @ w + b, 0), rtol=1e-5,
                               atol=1e-6)


def test_serving_plan_holds_few_values_at_once():
    """On the pruned Transformer the plan keeps the live set small: no
    intermediate survives its last reader (the eager stand-in for XLA's
    buffer liveness)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss = transformer.build(n_layer=2, d_model=64, n_head=2, d_ff=128,
                                    seq_len=8, src_vocab=32, tgt_vocab=32,
                                    is_test=True)
    serve, logits = transformer.inference_program(main, loss)
    block = serve.global_block()
    plan = texecutor._Plan(serve, [logits])
    live, peak = set(), 0
    for op, drop in plan.steps:
        live |= {n for n in op.input_arg_names + op.output_arg_names
                 if not block.var(n).persistable}
        peak = max(peak, len(live))
        live -= set(drop)
    assert live == {logits}
    assert peak <= 12 < len(plan.steps)


def test_feeds_take_the_variable_dtype_and_errors_name_the_variable():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[3], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 4])
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with pytest.raises(RuntimeError, match="not initialized"):
        exe.run(main, feed={"ids": np.zeros((1, 3), "int32")},
                fetch_list=[emb], scope=scope)
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed={"ids": np.array([[1, 2, 3]], "int32")},
                   fetch_list=[emb], scope=scope, return_numpy=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 3, 4)
    w = scope.get(main.all_parameters()[0].name)
    assert torch.equal(got[0], w[1:4])
    with pytest.raises(ValueError, match="nope"):
        exe.run(main, feed={"ids": np.zeros((1, 3), "int64")},
                fetch_list=["nope"], scope=scope)


def test_startup_initializers_follow_their_attrs_and_seed():
    def params(seed):
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[64], dtype="float32")
            fluid.layers.fc(input=x, size=32)
            fluid.layers.embedding(
                fluid.layers.data(name="i", shape=[1], dtype="int64"),
                size=[500, 16], dtype="bfloat16",
                param_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.Normal(0.0, 0.5)))
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        return {p.name: scope.get(p.name) for p in main.all_parameters()}

    a, b, c = params(3), params(3), params(4)
    limit = float(np.sqrt(6.0 / (64 + 32)))        # Xavier uniform
    w = a["fc_0.w_0"]
    assert w.dtype == torch.float32 and w.abs().max() <= limit
    assert w.abs().max() > 0.9 * limit
    assert torch.count_nonzero(a["fc_0.b_0"]) == 0
    emb = a["embedding_0.w_0"]
    assert emb.dtype == torch.bfloat16
    assert abs(emb.float().std().item() - 0.5) < 0.02
    assert abs(emb.float().mean().item()) < 0.02
    for n in a:
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["fc_0.w_0"], c["fc_0.w_0"])


def test_params_from_numpy_checks_names_shapes_and_keeps_bf16_bits():
    import ml_dtypes
    scope = fluid.Scope()
    scope.set("w", torch.zeros(2, 3, dtype=torch.bfloat16))
    with pytest.raises(KeyError):
        fluid.params_from_numpy({"missing": np.zeros((2, 3))}, scope, "cpu")
    with pytest.raises(ValueError, match="shape"):
        fluid.params_from_numpy({"w": np.zeros((3, 2))}, scope, "cpu")
    arr = np.random.RandomState(2).randn(2, 3).astype(ml_dtypes.bfloat16)
    fluid.params_from_numpy({"w": arr}, scope, "cpu")
    got = scope.get("w")
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          arr.view(np.uint16))
