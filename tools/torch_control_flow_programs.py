"""Programs that run control flow and tensor arrays (While, Switch, IfElse,
StaticRNN and the array ops), built on whichever ``fluid`` module the
caller passes: the port's (``paddle_tpu_torch.fluid``) or the JAX
package's (``paddle_tpu.fluid``). The same code gives the same program on
both, op for op, in every block.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.rnn_encoder_decoder(fluid, **tool.ENC_DEC_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.enc_dec_batch(0, **tool.ENC_DEC_NARROW),
            fetch_list=[m.loss])

- ``rnn_encoder_decoder``: the Fluid book's plain RNN encoder-decoder
  (tests/test_book.py ``test_rnn_encoder_decoder``, the reference's
  book/test_rnn_encoder_decoder.py): an embedding and a tanh StaticRNN
  over the source, the mean of its states as the decoder's first memory,
  an embedding and a tanh StaticRNN over the target, an fc over the
  vocabulary, softmax_with_cross_entropy, Adam(5e-3). ``ENC_DEC`` holds
  the widths of the WMT-14 seq2seq that the reference's benchmark/fluid
  machine_translation trains (dictionary 30,000, embedding 512, hidden
  512), at T 32 and batch 64; ``ENC_DEC_NARROW`` the book test's.
- ``while_loop``: benchmark/predictor_bench.py's While model (an fc, then
  8 trips of ``acc = tanh(fc(acc)) + acc``), served (``WHILE_SERVE``: fc
  32, batch 4) and trained (``WHILE_TRAIN``: width 1,024, batch 256, a
  squared error to a target, SGD) through while_grad with the bound that
  append_backward infers from the counter; ``max_trip_count`` sets a bound
  (the control: two below the trips, every gradient NaN).
  ``while_dropout``: a body that adds a dropout of ones each trip.
- ``switch``: the Switch programs of tests/test_control_flow_grad.py (the
  taken case, the untaken case, a case with a default) at width 1,024,
  batch 256: ``out = 2 * x * w`` under the case, ``5 * x * w`` under the
  default; ``ifelse``: its IfElse regressor (each branch scales x by its
  own parameter), SGD(0.5).
- ``tensor_arrays``: every array op at BERT-base's widths (hidden [256,
  128, 768] in bfloat16, lengths 1-128): lod_rank_table and
  max_sequence_len, lod_tensor_to_array and back, array_read, array_write
  and array_length, shrink_memory, reorder_lod_tensor_by_rank,
  split_lod_tensor and merge_lod_tensor, tensor_array_to_tensor and
  lod_reset.

``*_NARROW`` hold the widths of the CPU tests.
"""
import collections

import numpy as np

PROGRAMS = ("rnn_encoder_decoder", "while_loop", "switch_ifelse",
            "tensor_arrays")

Model = collections.namedtuple("Model", "main startup loss out feeds")

# ---- the book's RNN encoder-decoder ------------------------------------

ENC_DEC = dict(vocab=30000, emb=512, hid=512, seq=32, batch=64)
ENC_DEC_NARROW = dict(vocab=20, emb=10, hid=12, seq=5, batch=8)
ENC_DEC_LR = 5e-3


def _tanh_rnn(fluid, seq, hid, boot=None):
    """A StaticRNN over [B, T, E] whose step is fc([x_t, h], hid, tanh);
    its memory starts at `boot`, else at zeros of [B, hid]."""
    L = fluid.layers
    rnn = L.StaticRNN()
    with rnn.step():
        x = rnn.step_input(seq)
        h = rnn.memory(init=boot) if boot is not None else \
            rnn.memory(None, [-1, hid], x, 0.0)
        nh = L.fc(input=[x, h], size=hid, act="tanh")
        rnn.update_memory(h, nh)
        rnn.output(nh)
    return rnn()


def rnn_encoder_decoder(fluid, seed=47, **widths):
    """The book's model at `widths` (ENC_DEC's keys; ENC_DEC by
    default): main (with Adam), startup seeded with `seed`, the loss and
    the logits [B, T, V]."""
    w = dict(ENC_DEC, **widths)
    V, T = w["vocab"], w["seq"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = L.data(name="src", shape=[T], dtype="int64")
        tgt = L.data(name="tgt", shape=[T], dtype="int64")
        lbl = L.data(name="lbl", shape=[T, 1], dtype="int64")
        enc = _tanh_rnn(fluid, L.embedding(src, size=[V, w["emb"]]),
                        w["hid"])
        dec = _tanh_rnn(fluid, L.embedding(tgt, size=[V, w["emb"]]),
                        w["hid"], boot=L.reduce_mean(enc, dim=1))
        logits = L.fc(input=dec, size=V, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, lbl))
        fluid.optimizer.Adam(learning_rate=ENC_DEC_LR).minimize(loss)
    return Model(main, startup, loss, logits, ["src", "tgt"])


def enc_dec_batch(seed, **widths):
    """The book test's feeds: source ids in [1, V), the target the source
    shifted by one step, the labels the source."""
    w = dict(ENC_DEC, **widths)
    src = np.random.RandomState(seed).randint(
        1, w["vocab"], (w["batch"], w["seq"])).astype("int64")
    return {"src": src, "tgt": np.roll(src, 1, 1), "lbl": src[..., None]}


# ---- benchmark/predictor_bench.py's While model --------------------------

WHILE_SERVE = dict(trips=8, width=32, batch=4)
WHILE_TRAIN = dict(trips=8, width=1024, batch=256)
WHILE_NARROW = dict(trips=3, width=8, batch=4)
WHILE_LR = 0.01


def while_loop(fluid, seed=12, train=False, max_trip_count=None, **widths):
    """acc = fc(x, width); `trips` times acc = tanh(fc(acc)) + acc. With
    `train`, the loss is mean((acc - y)^2) and SGD(WHILE_LR) minimizes it;
    else the loss is None and `out` is acc."""
    w = dict(WHILE_SERVE, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[w["width"]], dtype="float32")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=w["trips"])
        acc = L.fc(input=x, size=w["width"],
                   param_attr=fluid.ParamAttr(name="w0"))
        cond = L.less_than(x=i, y=limit)
        with L.While(cond=cond, max_trip_count=max_trip_count).block():
            nxt = L.elementwise_add(
                L.fc(input=acc, size=w["width"], act="tanh",
                     param_attr=fluid.ParamAttr(name="wl")), acc)
            L.assign(nxt, acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        loss, feeds = None, ["x"]
        if train:
            y = L.data(name="y", shape=[w["width"]], dtype="float32")
            loss = L.mean(L.square(L.elementwise_sub(acc, y)))
            fluid.optimizer.SGD(learning_rate=WHILE_LR).minimize(loss)
            feeds = ["x", "y"]
    return Model(main, startup, loss, acc, feeds)


def while_batch(seed, **widths):
    w = dict(WHILE_SERVE, **widths)
    rng = np.random.RandomState(seed)
    shape = (w["batch"], w["width"])
    return {"x": rng.uniform(-1, 1, shape).astype("float32"),
            "y": rng.uniform(-1, 1, shape).astype("float32")}


def while_dropout(fluid, p=0.5, **widths):
    """acc += dropout(ones [batch, width], p) on each of `trips` trips:
    one mask on every trip leaves each element 0 or `trips`."""
    w = dict(WHILE_SERVE, **widths)
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        shape = [w["batch"], w["width"]]
        ones = L.fill_constant(shape, "float32", 1.0)
        acc = L.fill_constant(shape, "float32", 0.0)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=w["trips"])
        cond = L.less_than(x=i, y=limit)
        with L.While(cond=cond).block():
            L.assign(L.elementwise_add(acc, L.dropout(ones, p)), acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
    return Model(main, startup, None, acc, [])


# ---- tests/test_control_flow_grad.py's Switch and IfElse programs --------

BRANCHY = dict(width=1024, batch=256)
BRANCHY_NARROW = dict(width=4, batch=3)
SWITCH_CASES = {"taken": (1.0, False), "untaken": (3.0, False),
                "default": (3.0, True)}
IFELSE_LR = 0.5


def switch(fluid, case, **widths):
    """x [batch, width] and a parameter w [width] (ones); out starts at
    5; a Switch writes out = 2 * x * w when 1 < 2 ("taken") or 3 < 2
    ("untaken", "default"), and with a default out = 5 * x * w otherwise.
    The loss is mean(out); the gradients of x and w are appended."""
    a_val, with_default = SWITCH_CASES[case]
    w = dict(BRANCHY, **widths)
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[w["width"]], dtype="float32")
        x.stop_gradient = False
        wp = L.create_parameter(
            shape=[w["width"]], dtype="float32", name="w",
            default_initializer=fluid.initializer.ConstantInitializer(1.0))
        a = L.fill_constant([1], "float32", a_val)
        b = L.fill_constant([1], "float32", 2.0)
        out = L.fill_constant([w["batch"], w["width"]], "float32", 5.0)
        out.stop_gradient = False
        cond = L.less_than(a, b)
        xw = L.elementwise_mul(x, wp, axis=1)
        sw = L.Switch()
        with sw:
            with sw.case(cond):
                L.assign(L.scale(xw, scale=2.0), output=out)
            if with_default:
                with sw.default():
                    L.assign(L.scale(xw, scale=5.0), output=out)
        loss = L.mean(out)
        fluid.backward.append_backward(loss)
        fluid.backward.gradients(loss, [x])
    return Model(main, startup, loss, out, ["x"])


def ifelse(fluid, **widths):
    """Rows of x below 0.5 take x * wa, the others x * wb (one parameter
    a branch, ones at the start); squared error to y; SGD(IFELSE_LR)."""
    w = dict(BRANCHY, **widths)
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[w["width"]], dtype="float32")
        y = L.data(name="y", shape=[w["width"]], dtype="float32")
        cond = L.less_than(x, L.fill_constant([1], "float32", 0.5))
        init = fluid.initializer.ConstantInitializer(1.0)
        wa, wb = (L.create_parameter(shape=[w["width"]], dtype="float32",
                                     default_initializer=init)
                  for _ in range(2))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.elementwise_mul(ie.input(x), wa, axis=1))
        with ie.false_block():
            ie.output(L.elementwise_mul(ie.input(x), wb, axis=1))
        pred = ie()[0]
        loss = L.mean(L.square(L.elementwise_sub(pred, y)))
        fluid.optimizer.SGD(learning_rate=IFELSE_LR).minimize(loss)
    return Model(main, startup, loss, pred, ["x", "y"])


def branchy_batch(seed, **widths):
    """x in [0, 1); y = 3x below 0.5, -2x above (the test's target)."""
    w = dict(BRANCHY, **widths)
    x = np.random.RandomState(seed).rand(w["batch"], w["width"]) \
        .astype("float32")
    return {"x": x, "y": np.where(x < 0.5, 3.0 * x, -2.0 * x)
            .astype("float32")}


# ---- the tensor arrays at BERT-base's widths -----------------------------

ARRAYS = dict(batch=256, seq=128, hidden=768, step=5, dtype="bfloat16")
ARRAYS_NARROW = dict(batch=5, seq=4, hidden=3, step=2, dtype="float32")


def tensor_arrays(fluid, **widths):
    """Every array op over hidden states [batch, seq, hidden], their
    lengths [batch, 1] and a row mask [batch, 1]. `out` names each
    tensor the program makes: the rank table's max length, the states
    back from the array (in their rows' order), the array's step `step`
    and the array's length after that step is written at its end, the
    step with the rows that ended by then zeroed, the states in the rank
    table's order, both sides of the split and their merge, the array
    concatenated along axis 1 with each entry's width, the states with
    new lengths."""
    w = dict(ARRAYS, **widths)
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="hidden", shape=[w["seq"], w["hidden"]],
                   dtype=w["dtype"])
        lens = L.data(name="lens", shape=[1], dtype="int32")
        mask = L.data(name="mask", shape=[1], dtype="bool")
        table = L.lod_rank_table(x, length=lens)
        arr = L.lod_tensor_to_array(x, table)
        i = L.fill_constant(shape=[1], dtype="int64", value=w["step"])
        step = L.array_read(arr, i)
        end = L.fill_constant(shape=[1], dtype="int64", value=w["seq"])
        L.array_write(step, end, array=arr)
        t, f = L.split_lod_tensor(x, mask)
        cat, widths_ = L.tensor_array_to_tensor(arr, axis=1)
        out = collections.OrderedDict([
            ("max_len", L.max_sequence_len(table)),
            ("back", L.array_to_lod_tensor(L.lod_tensor_to_array(x, table),
                                           table)),
            ("step", step), ("length", L.array_length(arr)),
            ("shrunk", L.shrink_memory(step, i, table)),
            ("reordered", L.reorder_lod_tensor_by_rank(x, table)),
            ("true", t), ("false", f),
            ("merged", L.merge_lod_tensor(t, f, x, mask)),
            ("concat", cat), ("widths", widths_),
            ("reset", L.lod_reset(x, y=lens))])
    return Model(main, startup, None, out, ["hidden", "lens", "mask"])


def arrays_batch(seed, **widths):
    """Hidden states N(0, 1) (float32: the executor casts them to the
    variable's dtype), lengths 1..seq, a random row mask."""
    w = dict(ARRAYS, **widths)
    rng = np.random.RandomState(seed)
    return {"hidden": rng.randn(w["batch"], w["seq"], w["hidden"])
            .astype("float32"),
            "lens": rng.randint(1, w["seq"] + 1, (w["batch"], 1))
            .astype("int32"),
            "mask": rng.rand(w["batch"], 1) < 0.5}
