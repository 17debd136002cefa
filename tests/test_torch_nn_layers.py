"""The rest of the NN layers of ``fluid.layers`` on the port, against the
JAX package on the CPU.

- Every layer the slice adds exists under the JAX package's name with its
  signature.
- Each layer in a small program (an fc, the layer on the fc's output
  reshaped to a map, a sequence or a weight, a mean square of its float
  outputs, SGD): op for op the JAX package's, main and startup, and one
  step from the JAX package's parameters: the layer's outputs within 1e-5
  of their largest JAX value (the convolutions 1e-4; similarity_focus's
  masks equal), the loss within 1e-5 relative and the fc's gradients
  within 1e-5 (1e-4 past a convolution) of their largest JAX value.
  Sampled softmax's own draws differ between the packages: its loss is
  held by shape only and stays out of the program's loss.
- The layer that builds an op of a later item raises and names it:
  switch_moe; adaptive_pool2d(require_index=True), spp and unpool, which
  raised before the CTC and index-pooling slice, now build the JAX
  package's ops (held in tests/test_torch_ctc_pool_ops.py).
- conv2d_transpose's output_size gives the JAX package's filter size;
  adaptive_pool3d's op carries the adaptive attr its lowering ignores.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

TOL, CONV_TOL = 1e-5, 1e-4
N, W = 4, 48


def _maps(fl, h, shape=(N, 3, 4, 4)):
    return fl.layers.reshape(h, list(shape))


def _data(fl, name):
    value = np.asarray(FEEDS[name])
    return fl.layers.data(name=name, shape=list(value.shape),
                          dtype=str(value.dtype), append_batch_size=False)


def _theta(fl, h):
    return fl.layers.reshape(fl.layers.fc(input=h, size=6), [N, 2, 3])


def _stn(fl, h):
    """A spatial transformer: theta from an fc, affine_grid, grid_sampler;
    both outputs."""
    grid = fl.layers.affine_grid(_theta(fl, h), [N, 3, 5, 5])
    return [grid, fl.layers.grid_sampler(_maps(fl, h), grid)]


# name -> fn(fluid, h) building the layer on h = fc(x, 48) ([4, 48]); a
# feed it needs comes from FEEDS
LAYERS = {
    "conv2d_transpose": lambda fl, h: fl.layers.conv2d_transpose(
        _maps(fl, h), num_filters=4, filter_size=3, stride=2, padding=1),
    "conv2d_transpose_output_size": lambda fl, h: fl.layers.conv2d_transpose(
        _maps(fl, h), num_filters=2, output_size=8, stride=2, padding=1,
        act="relu"),
    "conv2d_transpose_groups": lambda fl, h: fl.layers.conv2d_transpose(
        _maps(fl, h), num_filters=6, filter_size=[2, 3], groups=3,
        dilation=2, bias_attr=False),
    "conv3d": lambda fl, h: fl.layers.conv3d(
        _maps(fl, h, (N, 3, 2, 2, 4)), num_filters=2, filter_size=2,
        padding=1, act="tanh"),
    "conv3d_transpose": lambda fl, h: fl.layers.conv3d_transpose(
        _maps(fl, h, (N, 3, 2, 2, 4)), num_filters=2, filter_size=2,
        stride=2),
    "pool3d": lambda fl, h: fl.layers.pool3d(
        _maps(fl, h, (N, 3, 2, 2, 4)), pool_size=2, pool_stride=1),
    "pool3d_avg": lambda fl, h: fl.layers.pool3d(
        _maps(fl, h, (N, 3, 2, 2, 4)), pool_size=[1, 2, 2],
        pool_type="avg", pool_stride=[1, 2, 2], pool_padding=[0, 1, 0]),
    "adaptive_pool2d": lambda fl, h: fl.layers.adaptive_pool2d(
        _maps(fl, h), 2, pool_type="avg"),
    "adaptive_pool3d": lambda fl, h: fl.layers.adaptive_pool3d(
        _maps(fl, h, (N, 3, 2, 4, 2)), [1, 2, 1]),
    "group_norm": lambda fl, h: fl.layers.group_norm(
        _maps(fl, h, (N, 6, 2, 4)), groups=3),
    "group_norm_no_affine": lambda fl, h: fl.layers.group_norm(
        _maps(fl, h, (N, 6, 2, 4)), groups=2, param_attr=False,
        bias_attr=False, act="relu"),
    "data_norm": lambda fl, h: fl.layers.data_norm(h),
    "affine_channel": lambda fl, h: fl.layers.affine_channel(
        _maps(fl, h), scale=fl.layers.create_parameter(
            [3], "float32", name="ac_scale",
            default_initializer=fl.initializer.Constant(1.5)),
        bias=fl.layers.create_parameter([3], "float32", name="ac_bias")),
    "lrn": lambda fl, h: fl.layers.lrn(_maps(fl, h, (N, 6, 2, 4)), n=5,
                                       alpha=1e-2),
    "image_resize": lambda fl, h: fl.layers.image_resize(_maps(fl, h),
                                                         scale=2.0),
    "resize_bilinear": lambda fl, h: fl.layers.resize_bilinear(
        _maps(fl, h), out_shape=[3, 2]),
    "resize_nearest": lambda fl, h: fl.layers.resize_nearest(
        _maps(fl, h), out_shape=[7, 3]),
    "image_resize_short": lambda fl, h: fl.layers.image_resize_short(
        _maps(fl, h, (N, 3, 2, 8)), 3),
    "affine_grid_and_grid_sampler": lambda fl, h: _stn(fl, h),
    "im2sequence": lambda fl, h: fl.layers.im2sequence(
        _maps(fl, h), filter_size=[2, 3], stride=[1, 1], padding=[1, 0]),
    "bilinear_tensor_product": lambda fl, h:
        fl.layers.bilinear_tensor_product(h, fl.layers.fc(input=h, size=10),
                                          size=5),
    "row_conv": lambda fl, h: fl.layers.row_conv(
        fl.layers.reshape(h, [N, 6, 8]), future_context_size=2),
    "spectral_norm": lambda fl, h: fl.layers.spectral_norm(
        fl.layers.reshape(h, [8, 24]), dim=0, power_iters=2),
    "fsp_matrix": lambda fl, h: fl.layers.fsp_matrix(
        _maps(fl, h), _maps(fl, fl.layers.scale(h, 2.0), (N, 3, 4, 4))),
    "similarity_focus": lambda fl, h: fl.layers.similarity_focus(
        _maps(fl, h), axis=1, indexes=[0, 2]),
    "tree_conv": lambda fl, h: fl.layers.tree_conv(
        fl.layers.reshape(h, [N, 6, 8]), _data(fl, "edges"), output_size=3,
        num_filters=2),
    "hsigmoid": lambda fl, h: fl.layers.hsigmoid(h, _data(fl, "label"),
                                                 num_classes=6),
    "sampled_softmax_customized": lambda fl, h:
        fl.layers.sampled_softmax_with_cross_entropy(
            fl.layers.fc(input=h, size=10), _data(fl, "label"),
            num_samples=3, use_customized_samples=True,
            customized_samples=_data(fl, "samples"),
            customized_probabilities=_data(fl, "probs")),
    "sampled_softmax": lambda fl, h:
        fl.layers.sampled_softmax_with_cross_entropy(
            fl.layers.fc(input=h, size=10), _data(fl, "label"),
            num_samples=3),
}
FEEDS = {
    "edges": np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [2, 5]]] * 2 +
                      [[[0, 1], [1, 2], [0, 0], [0, 0], [0, 0]]] * 2,
                      np.int32),
    "label": np.array([[1], [5], [0], [3]], np.int64),
    "samples": np.array([[1, 4, 1, 9], [5, 0, 2, 5], [0, 3, 8, 7],
                         [3, 6, 3, 2]], np.int64),
    "probs": np.random.RandomState(7).uniform(0.05, 0.3, (4, 4))
    .astype(np.float32),
}
RANDOM = {"sampled_softmax"}
CONVS = {"conv2d_transpose", "conv2d_transpose_output_size",
         "conv2d_transpose_groups", "conv3d", "conv3d_transpose"}
EXACT = {"similarity_focus", "pool3d", "resize_nearest", "im2sequence"}
LAYER_NAMES = ["conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d",
               "adaptive_pool2d", "adaptive_pool3d", "group_norm",
               "data_norm", "affine_channel", "lrn", "image_resize",
               "resize_bilinear", "resize_nearest", "image_resize_short",
               "grid_sampler", "affine_grid", "im2sequence",
               "bilinear_tensor_product", "row_conv", "spectral_norm",
               "fsp_matrix", "similarity_focus", "tree_conv", "hsigmoid",
               "sampled_softmax_with_cross_entropy", "switch_moe", "spp",
               "unpool"]


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


def test_the_layers_are_exported_with_the_jax_signatures():
    for name in LAYER_NAMES:
        assert inspect.signature(getattr(tfluid.layers, name)) == \
            inspect.signature(getattr(jfluid.layers, name)), name
        assert name in tfluid.layers.nn.__all__
        assert getattr(tfluid.layers, name).__module__ == \
            "paddle_tpu_torch.fluid.layers.nn"


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
            if o.dtype == "float32" and name not in RANDOM:
                loss = loss + L.mean(L.square(o))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, outs


def _feed(main):
    feed = {"x": np.random.RandomState(3).randn(N, 12).astype("float32")}
    block = main.global_block()
    feed.update({k: v for k, v in FEEDS.items() if k in block.vars})
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
    tol = CONV_TOL if name in CONVS else TOL
    for n, g, w in zip(fetch[1:], got[1:], want[1:]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, n
        if name in RANDOM and n in fetch[3:]:
            continue
        if name in EXACT and n in fetch[3:]:
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            assert np.abs(g - w).max() <= tol * (np.abs(w).max() or 1.0), n
    # the persistables the step wrote (parameters, spectral_norm's U and V)
    for n, w in state.items():
        jv, tv = np.asarray(jscope.get(n)), tscope.get(n).numpy()
        assert np.abs(tv - jv).max() <= tol * (np.abs(jv).max() or 1.0), n


def test_conv2d_transpose_output_size_gives_the_filter_size():
    """output_size 8 over a 4x4 map at stride 2, padding 1: filter (8 -
    3 * 2 + 2 - 1) // 1 + 1 = 4, and the output is 8x8."""
    main, _, _, outs = _programs(tfluid, "conv2d_transpose_output_size")
    conv, = [op for op in main.global_block().ops
             if op.type == "conv2d_transpose"]
    block = main.global_block()
    assert block.var(conv.input("Filter")[0]).shape == (3, 2, 4, 4)
    assert block.var(conv.output("Output")[0]).shape == (N, 2, 8, 8)


def test_adaptive_pool3d_op_carries_the_ignored_adaptive_attr():
    main, _, _, outs = _programs(tfluid, "adaptive_pool3d")
    pool, = [op for op in main.global_block().ops if op.type == "pool3d"]
    assert pool.attrs["adaptive"] is True and pool.attrs["ksize"] == \
        [1, 2, 1]
    # a window of pool_size at stride 1: [2, 4, 2] -> [2, 3, 2]
    assert main.global_block().var(outs[0].name).shape == (N, 3, 2, 3, 2)


def test_layers_of_later_items_raise_and_name_the_item():
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        x = L.data(name="x", shape=[3, 4, 4], dtype="float32")
        with pytest.raises(NotImplementedError, match="item 7"):
            L.switch_moe(x, 4, 16)
        # item 6's index pooling builds its ops now
        out, mask = L.adaptive_pool2d(x, 2, require_index=True)
        assert mask.dtype == "int32"
        assert L.spp(x).shape == (-1, 3 * (1 + 4 + 16))
        assert L.unpool(out, mask).shape == (-1, 3, 4, 4)
        assert [op.type for op in main.global_block().ops] == [
            "max_pool2d_with_index", "spp", "unpool"]
        with pytest.raises(ValueError):
            L.conv3d_transpose(L.reshape(x, [-1, 3, 4, 2, 2]), 2)
