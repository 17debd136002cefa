"""The tensor arrays and the LoD plumbing ops on the port against the JAX
package, on the CPU.

The 7 programs of tests/test_array_ops.py, and tensor_array_to_tensor and
rnn_memory_helper, built by both packages from the same code: op for op
the JAX package's (every block), then run by both executors on the same
seeded feeds. Every op here is a gather, a select, a mask or a length, so
each fetched value must equal the JAX package's exactly (dtype aside: the
port's max_sequence_len is the int64 its variable declares, where the JAX
package without x64 computes int32). The closed forms of the original
tests hold on the port's values.

Where the JAX package raises the port raises the same error: an array
index that is no constant of the program (an array read or written inside
a While) and an array op on the gradient path.

``test_the_cases_cover_the_slice``: the port holds 240 lowerings and the
JAX package's 5 env lowerings; each of this slice's 14 lowerings and 5 env
lowerings is an op of a program that one of the slice's test files holds
against the JAX package.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import registry as treg

from test_torch_control_flow import signature, programs, _names

# this slice's lowerings by the JAX module that holds them
SLICE = {
    "control_ops": {"while", "conditional_block", "while_grad",
                    "conditional_block_grad"},
    "array_ops": {"lod_array_length", "lod_rank_table", "max_sequence_len",
                  "shrink_rnn_memory", "reorder_lod_tensor_by_rank",
                  "split_lod_tensor", "merge_lod_tensor", "lod_reset",
                  "rnn_memory_helper"},
    "rnn_ops": {"recurrent"},
}
ENV_SLICE = {"write_to_array", "read_from_array", "lod_tensor_to_array",
             "array_to_lod_tensor", "tensor_array_to_tensor"}


def run_both(build, feed):
    """Both packages' programs (op for op equal), each run once; returns
    (JAX values, port values)."""
    (jm, js, jf), (tm, ts, tf) = programs(jfluid, build), \
        programs(tfluid, build)
    assert signature(jm) == signature(tm)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    want = jexe.run(jm, feed=feed, fetch_list=_names(jf), scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=_names(tf), scope=tscope)
    return [np.asarray(w) for w in want], [np.asarray(g) for g in got]


def assert_equal(want, got):
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the programs of tests/test_array_ops.py, on either package
# --------------------------------------------------------------------------

def write_read_length(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    arr = L.array_write(x, i)
    i2 = L.increment(i, in_place=False)
    arr = L.array_write(x * 2.0, i2, array=arr)
    return [L.array_length(arr), L.array_read(arr, i2)]


def rank_table_max_len(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4, 5], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int32")
    table = L.lod_rank_table(x, length=lens)
    return [L.max_sequence_len(table)]


def array_roundtrip(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4, 3], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int32")
    table = L.lod_rank_table(x, length=lens)
    arr = L.lod_tensor_to_array(x, table)
    return [L.array_to_lod_tensor(arr, table)]


def shrink_memory(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int32")
    table = L.lod_rank_table(x, length=lens)
    i = L.fill_constant(shape=[1], dtype="int64", value=2)
    return [L.shrink_memory(x, i, table)]


def reorder(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[2], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int32")
    table = L.lod_rank_table(x, length=lens)
    return [L.reorder_lod_tensor_by_rank(x, table)]


def split_merge(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[2], dtype="float32")
    mask = L.data(name="mask", shape=[1], dtype="bool")
    t, f = L.split_lod_tensor(x, mask)
    return [t, f, L.merge_lod_tensor(t, f, x, mask)]


def lod_reset_op(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="int32")
    helper = fluid.layer_helper.LayerHelper("lod_reset", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    olen = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_reset", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "OutLength": [olen]})
    return [out, olen]


def lod_reset_layer(fluid):
    """The lod_reset layer with target_lod offsets."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    return [L.lod_reset(x, target_lod=[0, 1, 4])]


def array_to_tensor(fluid):
    """Three steps written, then concatenated along axis 1."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    arr = L.array_write(x, i)
    for k in (2.0, 3.0):
        i = L.increment(i, in_place=False)
        L.array_write(L.scale(x, scale=k), i, array=arr)
    return list(L.tensor_array_to_tensor(arr, axis=1))


def memory_helper(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    helper = fluid.layer_helper.LayerHelper("rnn_memory_helper", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="rnn_memory_helper", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return [out]


def array_in_while(fluid):
    """An array read and written at the loop's counter."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    arr = L.array_write(x, i)
    lim = L.fill_constant(shape=[1], dtype="int64", value=3)
    cond = L.less_than(i, lim)
    with L.While(cond).block():
        y = L.array_read(arr, i)
        L.increment(i, in_place=True)
        L.array_write(L.scale(y, scale=2.0), i, array=arr)
        L.less_than(i, lim, cond=cond)
    return [L.array_length(arr)]


def array_on_grad_path(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    x.stop_gradient = False
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    arr = L.array_write(L.scale(x, scale=2.0), i)
    loss = L.mean(L.array_read(arr, i))
    return fluid.backward.gradients(loss, [x])


def _rand(*shape):
    return np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def test_array_write_read_length():
    xv = _rand(2, 3)
    want, got = run_both(write_read_length, {"x": xv})
    assert_equal(want, got)
    assert int(got[0]) == 2
    np.testing.assert_allclose(got[1], xv * 2.0, rtol=1e-6)


def test_lod_rank_table_and_max_len():
    feed = {"x": _rand(3, 4, 5), "lens": np.array([2, 4, 1], np.int32)}
    want, got = run_both(rank_table_max_len, feed)
    assert int(want[0]) == int(got[0]) == 4
    assert got[0].dtype == np.int64


def test_lod_tensor_array_roundtrip():
    xv = _rand(2, 4, 3)
    want, got = run_both(array_roundtrip,
                         {"x": xv, "lens": np.array([3, 4], np.int32)})
    assert_equal(want, got)
    np.testing.assert_array_equal(got[0], xv)


def test_shrink_memory_masks_finished_rows():
    xv = _rand(3, 4)
    want, got = run_both(shrink_memory,
                         {"x": xv, "lens": np.array([1, 3, 2], np.int32)})
    assert_equal(want, got)
    np.testing.assert_array_equal(got[0][0], xv[0])
    assert not got[0][1:].any()


def test_reorder_by_rank():
    xv = np.arange(6, dtype=np.float32).reshape(3, 2)
    want, got = run_both(reorder,
                         {"x": xv, "lens": np.array([1, 3, 2], np.int32)})
    assert_equal(want, got)
    np.testing.assert_array_equal(got[0], xv[[1, 2, 0]])


def test_split_merge_lod_tensor():
    xv = _rand(4, 2)
    mv = np.array([[1], [0], [1], [0]], bool)
    want, got = run_both(split_merge, {"x": xv, "mask": mv})
    assert_equal(want, got)
    t, f, merged = got
    np.testing.assert_array_equal(t[0], xv[0])
    assert not t[1].any()
    np.testing.assert_array_equal(f[1], xv[1])
    np.testing.assert_array_equal(merged, xv)


def test_lod_reset():
    xv, yv = _rand(4, 3), np.array([2, 2], np.int32)
    want, got = run_both(lod_reset_op, {"x": xv, "y": yv})
    assert_equal(want, got)
    np.testing.assert_array_equal(got[1], yv)
    want, got = run_both(lod_reset_layer, {"x": xv})
    assert_equal(want, got)


def test_tensor_array_to_tensor():
    xv = _rand(2, 3)
    want, got = run_both(array_to_tensor, {"x": xv})
    assert_equal(want, got)
    np.testing.assert_allclose(got[0], np.concatenate(
        [xv, 2 * xv, 3 * xv], axis=1), rtol=1e-6)
    np.testing.assert_array_equal(got[1], [3, 3, 3])


def test_rnn_memory_helper_is_the_identity():
    xv = _rand(2, 3)
    want, got = run_both(memory_helper, {"x": xv})
    assert_equal(want, got)
    np.testing.assert_array_equal(got[0], xv)


def test_array_inside_a_while_raises_as_in_jax():
    msgs = []
    for fluid in (jfluid, tfluid):
        main, startup, fetch = programs(fluid, array_in_while)
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(NotImplementedError,
                           match="not a trace-time constant") as e:
            exe.run(main, feed={"x": _rand(2, 3)},
                    fetch_list=_names(fetch), scope=fluid.Scope())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_array_op_on_the_gradient_path_raises_as_in_jax():
    msgs = []
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError,
                           match="on the gradient path") as e:
            programs(fluid, array_on_grad_path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_the_cases_cover_the_slice():
    """297 lowerings and 5 env lowerings in the port (203 before this
    slice, 232 with the sequence slice's 15, 240 with the recurrent
    slice's 8, 246 with the decoding slice's 6, 255 with the CTC and
    index-pooling slice's 9, 278 with the detection slice's 23, 297 with
    the compression slice's 19); each of
    the slice's 19
    is an op of a program held against the JAX package in
    tests/test_torch_array_ops.py, test_torch_control_flow.py or
    test_torch_static_rnn.py."""
    assert len(treg._LOWERINGS) == 297
    assert set(treg._ENV_LOWERINGS) == set(jreg._ENV_LOWERINGS) == ENV_SLICE

    def module(op):
        return jreg._LOWERINGS[op].__module__.rsplit(".", 1)[-1]
    # rnn_ops.py's other 8 came with the recurrent slice
    # (tests/test_torch_rnn_ops.py)
    later = {"rnn_ops": {"dynamic_lstm", "lstm", "dynamic_gru", "gru",
                         "lstmp", "cudnn_lstm", "gru_unit", "lstm_unit"}}
    for mod, ops in SLICE.items():
        assert {op for op in treg._LOWERINGS if module(op) == mod} == \
            ops | later.get(mod, set())
    assert sum(len(ops) for ops in SLICE.values()) == 14
    builders = [write_read_length, rank_table_max_len, array_roundtrip,
                shrink_memory, reorder, split_merge, lod_reset_op,
                array_to_tensor, memory_helper]
    cf = importlib.import_module("test_torch_control_flow")
    builders += [cf.inferred_bound, cf.taken_branch]
    rnn = importlib.import_module("test_torch_static_rnn")
    mains = [programs(tfluid, build)[0] for build in builders] + \
        [rnn._models()[1].main]
    types = set()
    for main in mains:
        types |= {op.type for b in main.blocks for op in b.ops}
        types |= {op.attrs["fwd_type"] for b in main.blocks for op in b.ops
                  if op.type == "grad_of"}
    assert set().union(*SLICE.values()) | ENV_SLICE <= types
