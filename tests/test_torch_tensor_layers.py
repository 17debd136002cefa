"""The tensor layers of ``fluid.layers`` and the four initializers
(TruncatedNormal, MSRA, Bilinear, NumpyArrayInitializer) on the port,
against the JAX package on the CPU.

- Every layer and initializer the slice adds exists under the JAX
  package's name with its signature (``force_init_on_cpu`` and
  ``init_on_cpu`` too, and the initializers' ``__all__``).
- Each layer in a small program (an fc, the layer, a mean square of its
  float outputs, SGD): op for op the JAX package's, main and startup, and
  one step from the JAX package's parameters: the layer's outputs equal
  to the JAX executor's (ops that move or pick values; within 1e-5 of the
  largest value where an op adds), the loss within 1e-5 relative and the
  fc's gradients within 1e-5 of their largest JAX value. The random
  layers' outputs are held by shape and dtype only (other generators),
  and stay out of the loss.
- The initializers' startup programs op for op; Bilinear and
  NumpyArrayInitializer (float32 and int32) bit for bit the numpy values
  and the JAX executor's; TruncatedNormal within +-2 std with the
  truncated variance 0.7737 std^2, MSRA uniform within sqrt(6 / fan_in)
  and both MSRA draws at variance 2 / fan_in, each within 5 standard
  errors; a startup program holding assign_value serialized to the JAX
  package's ``__model__`` bytes.
- merge_selected_rows and get_tensor_from_selected_rows on a sparse
  embedding's gradient: what the JAX executor holds there (the [n, dim]
  values, one row an id as looked up), in both packages.
"""
import inspect
import math

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

TOL = 1e-5
N, W = 4, 48


def _ids(fl, name, values):
    return fl.layers.data(name=name, shape=[len(values), 1], dtype="int64",
                          append_batch_size=False)


def _maps(fl, h):
    return fl.layers.reshape(h, [N, 3, 4, 4])


# name -> fn(fluid, h) building the layer on h = fc(x, 48) ([4, 48]); a
# feed it needs comes from FEEDS
LAYERS = {
    "squeeze": lambda fl, h: fl.layers.squeeze(
        fl.layers.reshape(h, [N, 1, W]), [1]),
    "unsqueeze": lambda fl, h: fl.layers.unsqueeze(h, [0, 2]),
    "stack": lambda fl, h: fl.layers.stack([h, fl.layers.scale(h, 2.0)],
                                           axis=1),
    "unstack": lambda fl, h: fl.layers.unstack(
        fl.layers.reshape(h, [N, 3, 16]), axis=1),
    "expand": lambda fl, h: fl.layers.expand(h, [2, 3]),
    "mul": lambda fl, h: fl.layers.mul(h, fl.layers.transpose(h, [1, 0])),
    "split": lambda fl, h: fl.layers.split(h, [8, 30, 10], dim=-1),
    "split_num": lambda fl, h: fl.layers.split(h, 4, dim=1),
    "shape": lambda fl, h: fl.layers.shape(h),
    "pad": lambda fl, h: fl.layers.pad(h, [1, 0, 2, 3], pad_value=0.5),
    "pad2d": lambda fl, h: fl.layers.pad2d(_maps(fl, h), [1, 2, 5, 0],
                                           mode="reflect"),
    "pad2d_edge": lambda fl, h: fl.layers.pad2d(
        _maps(fl, h), [2, 2, 1, 1], mode="edge", data_format="NHWC"),
    "pad_constant_like": lambda fl, h: fl.layers.pad_constant_like(
        fl.layers.concat([h, h], axis=0), h, pad_value=1.5),
    "gather": lambda fl, h: fl.layers.gather(h, _ids(fl, "idx",
                                                     FEEDS["idx"])),
    "scatter": lambda fl, h: fl.layers.scatter(
        h, _ids(fl, "idx", FEEDS["idx"]),
        fl.layers.fc(input=fl.layers.gather(h, _ids(fl, "idx",
                                                     FEEDS["idx"])),
                     size=W), overwrite=True),
    "scatter_add": lambda fl, h: fl.layers.scatter(
        h, _ids(fl, "idx", FEEDS["idx"]),
        fl.layers.fc(input=fl.layers.gather(h, _ids(fl, "idx",
                                                     FEEDS["idx"])),
                     size=W), overwrite=False),
    "random_crop": lambda fl, h: fl.layers.random_crop(_maps(fl, h),
                                                       [2, 3]),
    "crop": lambda fl, h: fl.layers.crop(_maps(fl, h), shape=[2, 3, 2, 4],
                                         offsets=[1, 0, 2, 0]),
    "space_to_depth": lambda fl, h: fl.layers.space_to_depth(_maps(fl, h),
                                                             2),
    "shuffle_channel": lambda fl, h: fl.layers.shuffle_channel(
        fl.layers.reshape(h, [N, 6, 2, 4]), 3),
    "uniform_random_batch_size_like":
        lambda fl, h: fl.layers.uniform_random_batch_size_like(
            h, [-1, 5], min=-0.5, max=0.5),
    "gaussian_random": lambda fl, h: fl.layers.gaussian_random([3, 7],
                                                               std=0.1),
    "gaussian_random_batch_size_like":
        lambda fl, h: fl.layers.gaussian_random_batch_size_like(
            h, [2, -1], input_dim_idx=1, output_dim_idx=1),
    "sampling_id": lambda fl, h: fl.layers.sampling_id(
        fl.layers.softmax(h)),
    "sum": lambda fl, h: fl.layers.sum([h, fl.layers.scale(h, 3.0), h]),
    "multiplex": lambda fl, h: fl.layers.multiplex(
        [h, fl.layers.scale(h, -1.0)],
        fl.layers.data(name="branch", shape=[N, 1], dtype="int32",
                       append_batch_size=False)),
    "reverse": lambda fl, h: fl.layers.reverse(h, 1),
    "reverse_tensor": lambda fl, h: fl.layers.tensor.reverse(h, [0, 1]),
    "merge_selected_rows": lambda fl, h: fl.layers.merge_selected_rows(h),
    "get_tensor_from_selected_rows":
        lambda fl, h: fl.layers.get_tensor_from_selected_rows(h),
    "fill_constant_batch_size_like":
        lambda fl, h: fl.layers.fill_constant_batch_size_like(
            h, [-1, 3], "float32", 0.25),
    "argmin": lambda fl, h: fl.layers.argmin(h),
    "argmax": lambda fl, h: fl.layers.argmax(h, axis=-1),
    "argsort": lambda fl, h: list(fl.layers.argsort(h, axis=1)),
    "has_inf": lambda fl, h: fl.layers.has_inf(h),
    "has_nan": lambda fl, h: fl.layers.has_nan(h),
    "range": lambda fl, h: fl.layers.range(0, 1, 0.1, "float32"),
    "range_int": lambda fl, h: fl.layers.range(2, 30, 3, "int64"),
    "zeros_like": lambda fl, h: fl.layers.zeros_like(h),
    "ones_like": lambda fl, h: fl.layers.ones_like(h),
    "assign_array": lambda fl, h: fl.layers.assign(
        np.linspace(-1, 1, 12).reshape(3, 4).astype("float32")),
    "assign_int_array": lambda fl, h: fl.layers.assign(
        np.arange(-3, 3).astype("int32")),
}
FEEDS = {"idx": [3, 0, 3, -1, 2], "branch": [[1], [0], [0], [1]]}
RANDOM = {"random_crop", "uniform_random_batch_size_like",
          "gaussian_random", "gaussian_random_batch_size_like",
          "sampling_id"}
ADDS = {"sum", "mul", "scatter_add"}

NN_LAYERS = ["squeeze", "unsqueeze", "stack", "unstack", "expand", "mul",
             "split", "shape", "pad", "pad2d", "pad_constant_like", "gather",
             "scatter", "random_crop", "crop", "space_to_depth",
             "shuffle_channel", "uniform_random_batch_size_like",
             "gaussian_random", "gaussian_random_batch_size_like",
             "sampling_id", "sum", "multiplex", "reverse",
             "merge_selected_rows", "get_tensor_from_selected_rows"]
TENSOR_LAYERS = ["fill_constant_batch_size_like", "argmin", "argmax",
                 "argsort", "has_inf", "has_nan", "range", "zeros_like",
                 "ones_like", "assign", "reverse"]
INITIALIZERS = ["TruncatedNormal", "MSRA", "Bilinear",
                "NumpyArrayInitializer", "TruncatedNormalInitializer",
                "MSRAInitializer", "BilinearInitializer",
                "force_init_on_cpu", "init_on_cpu"]


def _signature(program):
    """A program's global block as data (tests/torch_resnet_step.py's
    signature, attrs compared by value)."""
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


def test_the_layers_and_initializers_are_exported():
    for name in NN_LAYERS:
        assert inspect.signature(getattr(tfluid.layers.nn, name)) == \
            inspect.signature(getattr(jfluid.layers.nn, name)), name
    for name in TENSOR_LAYERS:
        assert inspect.signature(getattr(tfluid.layers.tensor, name)) == \
            inspect.signature(getattr(jfluid.layers.tensor, name)), name
    for name in set(NN_LAYERS + TENSOR_LAYERS):
        assert getattr(tfluid.layers, name).__module__.replace(
            "paddle_tpu_torch", "paddle_tpu") == \
            getattr(jfluid.layers, name).__module__, name
    assert tfluid.initializer.__all__ == jfluid.initializer.__all__
    for name in INITIALIZERS:
        t, j = getattr(tfluid.initializer, name), \
            getattr(jfluid.initializer, name)
        assert inspect.signature(t) == inspect.signature(j), name
    assert tfluid.initializer.TruncatedNormal is \
        tfluid.initializer.TruncatedNormalInitializer
    assert tfluid.initializer.force_init_on_cpu() is False
    with tfluid.initializer.init_on_cpu():
        pass


def _programs(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[N, 12], dtype="float32",
                   append_batch_size=False)
        h = L.fc(input=x, size=W)
        out = LAYERS[name](fluid, h)
        outs = out if isinstance(out, list) else [out]
        loss = L.mean(L.square(h))
        for o in outs:
            if o.dtype == "float32" and not o.stop_gradient and \
                    name not in RANDOM:
                loss = loss + L.mean(L.square(o))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, outs


def _feed(main):
    feed = {"x": np.random.RandomState(3).randn(N, 12).astype("float32")}
    block = main.global_block()
    for k, v in FEEDS.items():
        if k in block.vars:
            dtype = block.var(k).dtype
            feed[k] = np.asarray(v, dtype).reshape(block.var(k).shape)
    return feed


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_program_and_step_match_jax(name):
    jm, js, jloss, jouts = _programs(jfluid, name)
    tm, ts, tloss, touts = _programs(tfluid, name)
    assert _signature(jm) == _signature(tm)
    assert _signature(js) == _signature(ts)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None}
    tfluid.params_from_numpy(state, tscope, "cpu")
    feed = _feed(tm)
    grads = ["fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]
    fetch = [jloss.name] + grads + [o.name for o in jouts]
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    assert abs(float(got[0]) - float(want[0])) <= TOL * abs(float(want[0]))
    for n, g, w in zip(fetch[1:], got[1:], want[1:]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, n
        if name in RANDOM and n in fetch[3:]:
            continue
        if g.dtype.kind == "f" and (name in ADDS or n in grads):
            scale = np.abs(w).max() or 1.0
            assert np.abs(g - w).max() <= TOL * scale, n
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=n)
    for o in touts:
        assert o.dtype == {"shape": "int32", "argmin": "int64",
                           "argmax": "int64", "sampling_id": "int64",
                           "has_inf": "bool", "has_nan": "bool",
                           "range_int": "int64",
                           "assign_int_array": "int32"}.get(
            name, o.dtype if name == "argsort" else "float32"), name


def test_assign_of_a_numpy_array_takes_assign_value():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        out = tfluid.layers.assign(np.eye(2, dtype="float32"))
    op, = main.global_block().ops
    assert op.type == "assign_value" and op.attrs["values"] == \
        [[1.0, 0.0], [0.0, 1.0]] and out.dtype == "float32"
    with pytest.raises(TypeError):
        tfluid.layers.assign([1.0, 2.0])


# --------------------------------------------------------------------------
# the initializers
# --------------------------------------------------------------------------

SMALL_ZOO = {"trunc_normal": [64, 32], "msra_uniform": [16, 8, 3, 3],
             "msra_normal": [16, 8, 3, 3], "bilinear": [6, 6, 4, 4],
             "sinusoid": [16, 32], "int_table": [4, 8]}


def _tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_tensor_programs.py")
    spec = importlib.util.spec_from_file_location("torch_tensor_programs",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


tool = _tool()


def test_init_zoo_startup_is_op_for_op_the_jax_packages():
    jz = tool.init_zoo(jfluid, shapes=SMALL_ZOO)
    tz = tool.init_zoo(tfluid, shapes=SMALL_ZOO)
    assert _signature(jz.startup) == _signature(tz.startup)
    types = [op.type for op in tz.startup.global_block().ops]
    assert types == ["truncated_gaussian_random", "uniform_random",
                     "gaussian_random", "assign_value", "assign_value",
                     "assign_value"]
    assert tz.startup.serialize_to_string() == \
        jz.startup.serialize_to_string()


def test_bilinear_filter_shape_differs_by_channels():
    """Bilinear on a filter with other input channels than outputs puts
    the kernel on input channel 0 (the reference's indexing)."""
    for fl in (jfluid, tfluid):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            fl.layers.create_parameter(
                [3, 2, 3, 3], "float32", name="up",
                default_initializer=fl.initializer.Bilinear())
        op, = startup.global_block().ops
        vals = np.asarray(op.attrs["values"]).reshape(3, 2, 3, 3)
        assert (vals[:, 1] == 0).all() and (vals[:, 0] > 0).any()


@pytest.fixture(scope="module")
def zoo():
    """init_zoo at the port's models' shapes, its startup run by the
    port's executor on the CPU."""
    z = tool.init_zoo(tfluid, seed=3)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(z.startup, scope=scope)
    return z, {n: scope.get(n).numpy() for n in tool.ZOO}


def test_numpy_initializers_are_bit_for_bit(zoo):
    z, got = zoo
    for name in ("bilinear", "sinusoid", "int_table"):
        want = z.values[name]
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    jz = tool.init_zoo(jfluid, seed=3, shapes=SMALL_ZOO)
    tz = tool.init_zoo(tfluid, seed=3, shapes=SMALL_ZOO)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jz.startup, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tz.startup, scope=tscope)
    for name in ("bilinear", "sinusoid", "int_table"):
        np.testing.assert_array_equal(tscope.get(name).numpy(),
                                      np.asarray(jscope.get(name)))


def _var_within(x, var, fourth, n_se=5.0):
    x = np.asarray(x, np.float64).ravel()
    v = float(np.mean((x - x.mean()) ** 2))
    assert abs(v - var) <= n_se * math.sqrt((fourth - var ** 2) / x.size), \
        (v, var)


def test_truncated_normal_and_msra_draws(zoo):
    _, got = zoo
    std = tool.TRUNC_STD
    t = got["trunc_normal"]
    assert np.abs(t).max() <= 2 * std * (1 + 1e-6)
    pdf, z = math.exp(-2.0) / math.sqrt(2 * math.pi), math.erf(math.sqrt(2))
    var, fourth = 1 - 4 * pdf / z, 3 - 28 * pdf / z
    _var_within(t / std, var, fourth)
    fan_in = 512 * 9
    bound = math.sqrt(6.0 / fan_in)
    u, g = got["msra_uniform"], got["msra_normal"]
    assert np.abs(u).max() <= bound
    _var_within(u, 2.0 / fan_in, bound ** 4 / 5)
    _var_within(g, 2.0 / fan_in, 3 * (2.0 / fan_in) ** 2)


# --------------------------------------------------------------------------
# the selected-rows identities on a sparse gradient
# --------------------------------------------------------------------------

def _sparse_programs(fluid):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 2
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 4], is_sparse=True,
                                     param_attr=fluid.ParamAttr(name="emb"))
        loss = fluid.layers.mean(fluid.layers.square(emb))
        fluid.backward.append_backward(loss)
        block = main.global_block()
        outs = []
        for op_type in ("merge_selected_rows",
                        "get_tensor_from_selected_rows"):
            out = block.create_var(name=op_type + ".out", dtype="float32")
            block.append_op(type=op_type, inputs={"X": ["emb@GRAD"]},
                            outputs={"Out": [out.name]})
            outs.append(out.name)
    return main, startup, outs


def test_selected_rows_ops_pass_the_sparse_grads_values():
    """On a lookup_table(is_sparse=True) gradient both executors hold the
    [n, dim] values (n the ids looked up, repeats kept) and both ops hand
    them on unchanged."""
    ids = np.array([[3], [7], [3], [0], [3]], np.int64)
    results = []
    for fl in (jfluid, tfluid):
        main, startup, outs = _sparse_programs(fl)
        assert "emb@GRAD@ROWS" in main.global_block().vars
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        if fl is tfluid:
            tfluid.params_from_numpy({"emb": jemb}, scope, "cpu")
        else:
            jemb = np.asarray(scope.get("emb"))
        got = exe.run(main, feed={"ids": ids},
                      fetch_list=["emb@GRAD", "emb@GRAD@ROWS"] + outs,
                      scope=scope)
        results.append([np.asarray(g) for g in got])
    for want, got in zip(*results):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    grad, rows, merged, tensor = results[1]
    assert grad.shape == (5, 4) and rows.tolist() == [3, 7, 3, 0, 3]
    np.testing.assert_array_equal(merged, grad)
    np.testing.assert_array_equal(tensor, grad)
    np.testing.assert_allclose(grad, 2 * jemb[ids.ravel()] / 20, rtol=1e-6)
