"""The fused-op programs, built on whichever ``fluid`` module the caller
passes: the port's (``paddle_tpu_torch.fluid``) or the JAX package's
(``paddle_tpu.fluid``). The same code gives the same program on both, op
for op. No layer builds a fused op, so the fused programs append them op
by op through ``LayerHelper``; each fused program has an unfused twin
whose parameters it shares by name, so the twin's startup state runs
both.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.fused_stacked_lstm(fluid, **tool.STACKED_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.stacked_batch(0, **tool.STACKED_NARROW),
            fetch_list=[m.loss])

Each program function returns ``Model(main, startup, loss, out, feeds,
extra)``. Every program is float32, with random weights from the
startup's seed and seeded synthetic data: the IMDB, Criteo and ImageNet
files are not in the repository, so no accuracy is measured.

- ``fused_stacked_lstm`` (``fused=False``: its twin ``stacked_lstm``): the
  package's ``models/stacked_lstm.py`` (benchmark/fluid's
  stacked_dynamic_lstm) at fluid_benchmark's widths (tools/
  torch_fluid_benchmark.py: vocab 5,000, T 64, embedding 128, hidden 128,
  3 layers, 2 classes), batch 64, ragged lengths in [T / 2, T],
  Adam(0.001). The fused program runs each ``fc(bias_attr=False)`` ->
  ``dynamic_lstm`` pair as one ``fusion_lstm`` whose WeightX is the fc's
  weight, so it trains in lockstep with its twin.
  ``stacked_lstm_request(fluid, fused)`` is the test-mode request (the
  class probabilities of a batch); the fused request runs the first pair
  as ``fused_embedding_fc_lstm`` over ``FOLD`` = W_emb · W_fc, which
  ``fold_embedding_fc`` writes into a trained scope (the reference's
  embedding_fc_lstm_fuse_pass).
- ``fused_ctr`` (twin ``ctr``): a Criteo-shaped CTR model, batch 4,096,
  SGD(0.001): 26 multi-hot slots (lengths 1-8, ids below 100,000) pooled
  from one [100,000, 10] table through ``fused_embedding_seq_pool`` (the
  deep part) and from a [100,000, 1] table through
  ``fusion_seqpool_concat`` (the first-order terms); 13 dense features
  through ``fusion_squared_mat_sub`` with V [13, 10] and scalar 0.5 (the
  FM second-order term); the deep tower ``fusion_repeated_fc_relu`` at
  400-400-400 (DeepFM, Guo et al. 2017, section 3); one fc over the
  three to a logit, sigmoid cross-entropy. ``out`` is the click
  probability (the served request).
- ``fused_resnet50``: ResNet-50 of the package's ``models/resnet.py``
  (224, 1,000 classes) as an ``is_test`` request of 64 images. Its batch
  norms hold drawn statistics (``draw_bn_stats``); ``InferenceTranspiler``
  folds each into its conv (``transpiled``), and ``fuse_conv_epilogues``
  then turns each conv + bias (+ shortcut) (+ ReLU) into one
  ``conv2d_fusion`` (the reference's conv_elementwise_add_act_fuse_pass).
  ``extra["unfused"]`` is the transpiled request before that pass.
- ``fusion_chain``: every fused op the programs above do not run, forward
  and backward through ``append_backward`` and SGD(0.001), each at a
  shape its source uses: ``fused_elemwise_activation`` in both functor
  orders on BERT-base's FFN ([32,768, 768] · W [768, 3,072], the bias
  add and GELU, then a residual of GELU); ``fusion_gru`` forward and
  reverse at crnn_ctc's fc -> dynamic_gru(200, candidate relu) pairs
  ([32, 64, 768]); ``fusion_seqconv_eltadd_relu`` at the book's sentiment
  conv net (embedding 128, context 3, 512 filters; batch 128, reviews
  padded to 256); ``fusion_seqexpand_concat_fc`` over a [64, 64, 128]
  sequence and two [64, 128] per-sequence inputs to 128 (tanh);
  ``fusion_transpose_flatten_concat`` over MobileNet-SSD's six 3 x 3 box
  heads at batch 64 (maps 19, 10, 5, 3, 2 and 1 wide of 512, 1,024, 512,
  256, 256 and 128 channels, 3 or 6 priors a place); and
  ``conv2d_inception_fusion`` at GoogLeNet's inception (3a) input
  ([64, 192, 28, 28]; 1 x 1 x 64, 3 x 3 x 128, 5 x 5 x 32 and 1 x 1 x 32
  filters); ``attention_lstm`` at the stacked LSTM's widths (batch 64,
  T 64, M 128, D 128). The loss sums the means of the float outputs.

``*_NARROW`` hold the widths of the CPU tests. ``PROGRAMS`` maps each
training program's name to (build function, batch, narrow widths).
"""
import collections
import importlib

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")

LSTM_ATTRS = {"use_peepholes": False, "gate_activation": "sigmoid",
              "cell_activation": "tanh", "candidate_activation": "tanh"}


def _module(fluid, name):
    """The package's models/<name>.py (the port's or the JAX package's)."""
    return importlib.import_module(
        fluid.__name__.split(".")[0] + ".models." + name)


def _append(helper, op_type, inputs, outs, attrs=None, dtypes=None):
    """One op of `op_type` with a new variable in each output slot of
    `outs` (a slot: a count of variables); returns {slot: [vars]}."""
    dtypes = dtypes or {}
    out = {slot: [helper.create_variable_for_type_inference(
        dtypes.get(slot, "float32")) for _ in range(n)]
        for slot, n in outs.items()}
    helper.append_op(type=op_type, inputs=inputs, outputs=out,
                     attrs=attrs or {})
    return out


def _param(fluid, name, shape, bias=False):
    init = fluid.initializer.Constant(0.0) if bias else \
        fluid.initializer.Xavier()
    return fluid.layers.create_parameter(shape, "float32", name=name,
                                         default_initializer=init)


# ---- the stacked LSTM -------------------------------------------------------

STACKED = dict(vocab=5000, seq=64, emb=128, hidden=128, layers=3, classes=2,
               batch=64, lr=0.001)
STACKED_NARROW = dict(vocab=40, seq=10, emb=6, hidden=5, layers=3,
                      classes=2, batch=4, lr=0.001)
EMB, FC0 = "embedding_0.w_0", "fc_0.w_0"
FOLD = "embedding_0.w_0@FC_FOLD"


def _lstm_names(i):
    return "fc_%d.w_0" % i, "dynamic_lstm_%d.w_0" % i, \
        "dynamic_lstm_%d.b_0" % i


def _fusion_lstm(fluid, x, in_dim, w, length, i, first_ids=None):
    """Pair i of the stacked LSTM as one fused op over the twin's
    parameters: fusion_lstm on x, or fused_embedding_fc_lstm on the ids
    `first_ids` over FOLD."""
    wx_name, wh_name, b_name = _lstm_names(i)
    h = w["hidden"]
    helper = fluid.layer_helper.LayerHelper("fusion_lstm")
    wh = _param(fluid, wh_name, [h, 4 * h])
    b = _param(fluid, b_name, [1, 4 * h], bias=True)
    attrs = dict(LSTM_ATTRS, is_reverse=(i % 2) == 1)
    ins = {"WeightH": [wh], "Bias": [b], "Length": [length]}
    if first_ids is not None:
        ins.update(Ids=[first_ids], Embeddings=[
            _param(fluid, FOLD, [w["vocab"], 4 * h])])
        op_type = "fused_embedding_fc_lstm"
    else:
        ins.update(X=[x], WeightX=[_param(fluid, wx_name, [in_dim, 4 * h])])
        op_type = "fusion_lstm"
    out = _append(helper, op_type, ins, {"Hidden": 1, "Cell": 1, "XX": 1},
                  attrs)
    return out["Hidden"][0]


def _stacked_head(fluid, hidden, length, label, w):
    """The max pool over time, the classifier (named as the twin's) and
    the loss: (loss, class probabilities)."""
    L = fluid.layers
    hidden.seq_length_var = length.name
    pooled = L.sequence_pool(hidden, "max")
    k = w["layers"]
    logits = L.fc(input=pooled, size=w["classes"],
                  param_attr=fluid.ParamAttr(name="fc_%d.w_0" % k),
                  bias_attr=fluid.ParamAttr(name="fc_%d.b_0" % k))
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    prob = L.softmax(logits)
    L.accuracy(input=prob, label=label)
    return loss, prob


def _stacked_programs(fluid, fused, seed, train, fold, widths):
    w = dict(STACKED, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if not fused:
            _module(fluid, "stacked_lstm").build(
                vocab_size=w["vocab"], seq_len=w["seq"], emb_dim=w["emb"],
                hidden_dim=w["hidden"], stacked_num=w["layers"],
                class_num=w["classes"])
            block = main.global_block()
            loss = block.var([op for op in block.ops
                              if op.type == "mean"][-1].output("Out")[0])
            prob = block.var([op for op in block.ops
                              if op.type == "softmax"][-1].output("Out")[0])
        else:
            words = L.data(name="words", shape=[w["seq"]], dtype="int64",
                           lod_level=1)
            label = L.data(name="label", shape=[1], dtype="int64")
            length = main.global_block().var(words.seq_length_var)
            if fold:
                hidden = _fusion_lstm(fluid, None, None, w, length, 0,
                                      first_ids=words)
            else:
                emb = L.embedding(input=words, size=[w["vocab"], w["emb"]])
                hidden = _fusion_lstm(fluid, emb, w["emb"], w, length, 0)
            for i in range(1, w["layers"]):
                hidden = _fusion_lstm(fluid, hidden, w["hidden"], w,
                                      length, i)
            loss, prob = _stacked_head(fluid, hidden, length, label, w)
        if train:
            fluid.optimizer.Adam(learning_rate=w["lr"]).minimize(loss)
    return Model(main, startup, loss, prob, ["words", "words@LEN", "label"],
                 {"widths": w})


def stacked_lstm(fluid, seed=120, **widths):
    """The unfused twin: models/stacked_lstm.py with Adam."""
    return _stacked_programs(fluid, False, seed, True, False, widths)


def fused_stacked_lstm(fluid, seed=120, **widths):
    """Each fc -> dynamic_lstm pair one fusion_lstm, with Adam."""
    return _stacked_programs(fluid, True, seed, True, False, widths)


def stacked_lstm_request(fluid, fused, **widths):
    """The test-mode request pruned to `out`, the probabilities: the
    twin's, or with its first pair fused_embedding_fc_lstm over FOLD."""
    m = _stacked_programs(fluid, fused, 120, False, fused, widths)
    feeds = ["words", "words@LEN"]
    return Model(m.main.clone(for_test=True)._prune(feeds, [m.out.name]),
                 m.startup, None, m.out, feeds, m.extra)


def fold_embedding_fc(scope):
    """FOLD = W_emb · W_fc of the first pair, from `scope`'s values (the
    product on the values' device)."""
    scope.set(FOLD, scope.get(EMB) @ scope.get(FC0))


def stacked_batch(seed, **widths):
    """Uniform ids, lengths in [T / 2, T] (fluid_benchmark's generator),
    uniform labels; the pad positions hold ids too."""
    w = dict(STACKED, **widths)
    rng = np.random.RandomState(seed)
    b, t = w["batch"], w["seq"]
    return {"words": rng.randint(0, w["vocab"], (b, t)).astype(np.int64),
            "words@LEN": rng.randint(t // 2, t + 1, (b,)).astype(np.int64),
            "label": rng.randint(0, w["classes"], (b, 1)).astype(np.int64)}


# ---- the CTR model ----------------------------------------------------------

CTR = dict(slots=26, max_len=8, vocab=100000, emb=10, dense=13, factors=10,
           tower=[400, 400, 400], batch=4096, lr=0.001)
CTR_NARROW = dict(slots=3, max_len=4, vocab=30, emb=3, dense=4, factors=3,
                  tower=[5, 5, 5], batch=6, lr=0.001)


def _ctr_programs(fluid, fused, seed, widths):
    w = dict(CTR, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper("fused_ctr")
        slots = [L.data(name="slot_%d" % i, shape=[w["max_len"]],
                        dtype="int64", lod_level=1)
                 for i in range(w["slots"])]
        lens = [main.global_block().var(s.seq_length_var) for s in slots]
        dense = L.data(name="dense", shape=[w["dense"]], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="float32")
        table = _param(fluid, "ctr_emb", [w["vocab"], w["emb"]])
        first_w = fluid.ParamAttr(name="ctr_first")
        v = _param(fluid, "ctr_fm_v", [w["dense"], w["factors"]])
        ws = [_param(fluid, "ctr_tower_%d.w" % k, [i, o]) for k, (i, o) in
              enumerate(zip([w["slots"] * w["emb"] + w["dense"]] +
                            w["tower"][:-1], w["tower"]))]
        bs = [_param(fluid, "ctr_tower_%d.b" % k, [o], bias=True)
              for k, o in enumerate(w["tower"])]
        first_seqs = [L.embedding(input=s, size=[w["vocab"], 1],
                                  param_attr=first_w) for s in slots]
        if fused:
            deep = [_append(helper, "fused_embedding_seq_pool",
                            {"W": [table], "Ids": [s], "Length": [n]},
                            {"Out": 1}, {"combiner": "sum"})["Out"][0]
                    for s, n in zip(slots, lens)]
            first = _append(helper, "fusion_seqpool_concat",
                            {"X": first_seqs, "Length": lens}, {"Out": 1},
                            {"pooltype": "SUM", "axis": 1})["Out"][0]
            fm = _append(helper, "fusion_squared_mat_sub",
                         {"X": [dense], "Y": [v]},
                         {"SquaredX": 1, "SquaredY": 1, "SquaredXY": 1,
                          "Out": 1}, {"scalar": 0.5})["Out"][0]
            h = _append(helper, "fusion_repeated_fc_relu",
                        {"X": [L.concat(deep + [dense], axis=1)],
                         "W": ws, "Bias": bs},
                        {"ReluOut": len(ws) - 1, "Out": 1})["Out"][0]
        else:
            deep = [L.sequence_pool(L.embedding(
                input=s, size=[w["vocab"], w["emb"]],
                param_attr=fluid.ParamAttr(name="ctr_emb")), "sum")
                for s in slots]
            first = L.concat([L.sequence_pool(e, "sum")
                              for e in first_seqs], axis=1)
            xy = L.matmul(dense, v)
            x2v2 = L.matmul(L.square(dense), L.square(v))
            fm = L.scale(L.elementwise_sub(L.square(xy), x2v2), scale=0.5)
            h = L.concat(deep + [dense], axis=1)
            for wk, bk in zip(ws, bs):
                h = L.relu(L.elementwise_add(L.matmul(h, wk), bk))
        logit = L.fc(input=[h, first, fm], size=1,
                     param_attr=[fluid.ParamAttr(name="ctr_out.w_%d" % k)
                                 for k in range(3)],
                     bias_attr=fluid.ParamAttr(name="ctr_out.b"))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        prob = L.sigmoid(logit)
        fluid.optimizer.SGD(learning_rate=w["lr"]).minimize(loss)
    feeds = [n for s in slots for n in (s.name, s.seq_length_var)] + \
        ["dense", "label"]
    return Model(main, startup, loss, prob, feeds, {"widths": w})


def ctr(fluid, seed=121, **widths):
    """The unfused twin of fused_ctr."""
    return _ctr_programs(fluid, False, seed, widths)


def fused_ctr(fluid, seed=121, **widths):
    return _ctr_programs(fluid, True, seed, widths)


def ctr_batch(seed, **widths):
    """Each slot's ids uniform below vocab, its lengths uniform in [1,
    max_len] (the padding holds ids too, which the pools mask); dense
    features N(0, 1); clicks with probability 1/4."""
    w = dict(CTR, **widths)
    rng = np.random.RandomState(seed)
    b = w["batch"]
    out = {}
    for i in range(w["slots"]):
        out["slot_%d" % i] = rng.randint(
            0, w["vocab"], (b, w["max_len"])).astype(np.int64)
        out["slot_%d@LEN" % i] = rng.randint(
            1, w["max_len"] + 1, (b,)).astype(np.int64)
    out["dense"] = rng.randn(b, w["dense"]).astype(np.float32)
    out["label"] = (rng.rand(b, 1) < 0.25).astype(np.float32)
    return out


# ---- ResNet-50's request with conv2d_fusion ---------------------------------

RESNET = dict(dataset="flowers", depth=50, classes=1000, image=[3, 224, 224],
              batch=64)
RESNET_NARROW = dict(dataset="cifar10", depth=8, classes=10,
                     image=[3, 16, 16], batch=2)


def resnet_request(fluid, seed=122, **widths):
    """The is_test ResNet (``out`` its probabilities), pruned to them: no
    transpiler yet."""
    w = dict(RESNET, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _module(fluid, "resnet").build(
            dataset=w["dataset"], depth=w["depth"], class_dim=w["classes"],
            is_test=True)
        block = main.global_block()
        prob = block.var([op for op in block.ops
                          if op.type == "softmax"][-1].output("Out")[0])
    request = main._prune(["img"], [prob.name])
    return Model(request, startup, None, prob, ["img"], {"widths": w})


def draw_bn_stats(program, seed):
    """{name: value}: a running mean N(0, 0.1) and variance U(0.5, 1.5) for
    every batch norm of `program` (a folded batch norm then moves its conv's
    filter and bias)."""
    rng = np.random.RandomState(seed)
    out = {}
    block = program.global_block()
    for op in block.ops:
        if op.type == "batch_norm":
            c = block.var(op.input("Mean")[0]).shape[0]
            out[op.input("Mean")[0]] = (rng.randn(c) * 0.1).astype(
                np.float32)
            out[op.input("Variance")[0]] = rng.uniform(0.5, 1.5, c).astype(
                np.float32)
    return out


def _consumers(ops, name):
    return [k for k, op in enumerate(ops) if name in op.input_arg_names]


def fuse_conv_epilogues(program):
    """In place: each conv2d whose output only an elementwise_add of a
    bias reads becomes one conv2d_fusion with that bias, taking along the
    residual elementwise_add and the relu that follow where they are the
    only readers (activation ``identity`` where no relu follows). The
    fused op sits where the last op it replaces sat. Returns the number of
    conv2d_fusion ops."""
    block = program.global_block()
    fused = 0
    k = 0
    while k < len(block.ops):
        ops = block.ops
        conv = ops[k]
        if conv.type != "conv2d":
            k += 1
            continue
        readers = _consumers(ops, conv.output("Output")[0])
        if len(readers) != 1 or ops[readers[0]].type != "elementwise_add" \
                or ops[readers[0]].input("X")[0] != conv.output("Output")[0]:
            k += 1
            continue
        chain = [k, readers[0]]
        out = ops[readers[0]].output("Out")[0]
        bias = ops[readers[0]].input("Y")[0]
        resid = None
        nxt = _consumers(ops, out)
        if len(nxt) == 1 and ops[nxt[0]].type == "elementwise_add" and \
                ops[nxt[0]].input("Y")[0] == out:
            resid = ops[nxt[0]].input("X")[0]
            chain.append(nxt[0])
            out = ops[nxt[0]].output("Out")[0]
            nxt = _consumers(ops, out)
        act = "identity"
        if len(nxt) == 1 and ops[nxt[0]].type == "relu":
            act = "relu"
            chain.append(nxt[0])
            out = ops[nxt[0]].output("Out")[0]
        elif resid is not None:
            # a residual add with no relu after it stays as it is
            chain.pop()
            out = ops[chain[-1]].output("Out")[0]
            resid = None
        inputs = {"Input": conv.input("Input"), "Filter": conv.input("Filter"),
                  "Bias": [bias]}
        if resid is not None:
            inputs["ResidualData"] = [resid]
        attrs = {key: conv.attr(key) for key in
                 ("strides", "paddings", "dilations", "groups")}
        attrs["activation"] = act
        at = chain[-1]
        for j in sorted(chain, reverse=True):
            block.remove_op(j)
        block.insert_op(at - (len(chain) - 1), type="conv2d_fusion",
                        inputs=inputs, outputs={"Output": [out]},
                        attrs=attrs)
        fused += 1
        k = at - (len(chain) - 1) + 1
    program._bump_version()
    return fused


def fused_resnet50(fluid, exe, place, scope, seed=122, **widths):
    """The request's startup run by `exe` in `scope`, the batch norms'
    statistics drawn, the request transpiled over `scope`, then its conv
    epilogues fused: a Model whose main is the fused request, extra
    ``unfused`` the transpiled one and ``fused_ops`` their count."""
    m = resnet_request(fluid, seed, **widths)
    exe.run(m.startup, scope=scope)
    for n, v in draw_bn_stats(m.main, seed).items():
        scope.set(n, _like(scope.get(n), v))
    unfused = m.main.clone(for_test=True)
    fluid.transpiler.InferenceTranspiler().transpile(unfused, place, scope)
    fused = unfused.clone(for_test=True)
    count = fuse_conv_epilogues(fused)
    return Model(fused, m.startup, None, m.out, ["img"],
                 dict(m.extra, unfused=unfused, fused_ops=count))


def _like(old, value):
    """`value` (numpy) as the scope's kind of value beside `old`: a torch
    tensor on old's device for the port, the array itself for JAX."""
    if type(old).__module__.startswith("torch"):
        import torch
        return torch.from_numpy(value).to(old.device)
    return value


def resnet_batch(seed, **widths):
    w = dict(RESNET, **widths)
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(w["batch"], *w["image"]).astype(np.float32)}


# ---- the chain --------------------------------------------------------------

CHAIN = dict(ffn_rows=32768, ffn_in=768, ffn=3072,
             gru_batch=32, gru_t=64, gru_in=768, gru_hidden=200,
             conv_batch=128, conv_t=256, conv_emb=128, conv_ctx=3,
             conv_filters=512,
             expand_batch=64, expand_t=64, expand_seq=128, expand_vec=128,
             expand_out=128,
             ssd_batch=64, ssd_heads=[[512, 19, 3], [1024, 10, 6],
                                      [512, 5, 6], [256, 3, 6], [256, 2, 6],
                                      [128, 1, 6]],
             inc_batch=64, inc_in=192, inc_side=28,
             inc_filters=[[64, 1], [128, 3], [32, 5], [32, 1]],
             att_batch=64, att_t=64, att_m=128, att_d=128, lr=0.001)
CHAIN_NARROW = dict(ffn_rows=6, ffn_in=4, ffn=5,
                    gru_batch=3, gru_t=5, gru_in=4, gru_hidden=3,
                    conv_batch=3, conv_t=6, conv_emb=4, conv_ctx=3,
                    conv_filters=5,
                    expand_batch=3, expand_t=4, expand_seq=3, expand_vec=2,
                    expand_out=4,
                    ssd_batch=2, ssd_heads=[[3, 4, 3], [4, 2, 6]],
                    inc_batch=2, inc_in=3, inc_side=5,
                    inc_filters=[[2, 1], [3, 3], [2, 5], [2, 1]],
                    att_batch=3, att_t=4, att_m=3, att_d=2, lr=0.001)
GRU_ATTRS = {"activation": "relu", "gate_activation": "sigmoid",
             "origin_mode": False}


def fusion_chain(fluid, seed=123, **widths):
    """The chain at `widths` (CHAIN's keys): main (SGD), startup seeded
    with `seed`, the loss; ``extra["outputs"]`` the fused ops' outputs by
    op type."""
    w = dict(CHAIN, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    outs = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper("fusion_chain")

        def data(name, shape, dtype="float32"):
            return L.data(name=name, shape=shape, dtype=dtype,
                          append_batch_size=False)

        def fused(op_type, inputs, slots, attrs=None):
            o = _append(helper, op_type, inputs, slots, attrs)
            outs.setdefault(op_type, []).extend(
                v for vs in o.values() for v in vs)
            return o
        # BERT-base's FFN: gelu(x W1 + b1), then that + gelu(x W1)
        x = data("ffn_x", [w["ffn_rows"], w["ffn_in"]])
        h = L.matmul(x, _param(fluid, "ffn_w1", [w["ffn_in"], w["ffn"]]))
        b1 = _param(fluid, "ffn_b1", [w["ffn"]], bias=True)
        a = fused("fused_elemwise_activation", {"X": [h], "Y": [b1]},
                  {"Out": 1, "IntermediateOut": 1},
                  {"functor_list": ["gelu", "elementwise_add"],
                   "axis": -1})["Out"][0]
        fused("fused_elemwise_activation", {"X": [a], "Y": [h]},
              {"Out": 1, "IntermediateOut": 1},
              {"functor_list": ["elementwise_add", "gelu"], "axis": -1})
        # crnn_ctc's forward and reverse GRU pairs
        gx = data("gru_x", [w["gru_batch"], w["gru_t"], w["gru_in"]])
        glen = data("gru_x@LEN", [w["gru_batch"]], "int64")
        hid = w["gru_hidden"]
        for k, rev in enumerate((False, True)):
            fused("fusion_gru", {
                "X": [gx], "Length": [glen],
                "WeightX": [_param(fluid, "gru_%d.wx" % k,
                                   [w["gru_in"], 3 * hid])],
                "WeightH": [_param(fluid, "gru_%d.wh" % k, [hid, 3 * hid])],
                "Bias": [_param(fluid, "gru_%d.b" % k, [1, 3 * hid],
                                bias=True)]},
                {"Hidden": 1, "XX": 1}, dict(GRU_ATTRS, is_reverse=rev))
        # the sentiment conv net's sequence_conv + bias + relu
        cx = data("conv_x", [w["conv_batch"], w["conv_t"], w["conv_emb"]])
        clen = data("conv_x@LEN", [w["conv_batch"]], "int64")
        ctx_len = w["conv_ctx"]
        fused("fusion_seqconv_eltadd_relu", {
            "X": [cx], "Length": [clen],
            "Filter": [_param(fluid, "seqconv.w", [ctx_len * w["conv_emb"],
                                                   w["conv_filters"]])],
            "Bias": [_param(fluid, "seqconv.b", [w["conv_filters"]],
                            bias=True)]},
            {"Out": 1}, {"contextLength": ctx_len,
                         "contextStart": -(ctx_len // 2),
                         "contextStride": 1})
        # a sequence with two per-sequence inputs, broadcast and one fc
        ex = [data("expand_seq", [w["expand_batch"], w["expand_t"],
                                  w["expand_seq"]]),
              data("expand_a", [w["expand_batch"], w["expand_vec"]]),
              data("expand_b", [w["expand_batch"], w["expand_vec"]])]
        width = w["expand_seq"] + 2 * w["expand_vec"]
        fused("fusion_seqexpand_concat_fc", {
            "X": ex,
            "FCWeight": [_param(fluid, "expand.w", [width,
                                                    w["expand_out"]])],
            "FCBias": [_param(fluid, "expand.b", [w["expand_out"]],
                              bias=True)]},
            {"Out": 1}, {"fc_activation": "tanh"})
        # MobileNet-SSD's six box heads, transposed, flattened, concatenated
        heads = []
        for k, (c, side, priors) in enumerate(w["ssd_heads"]):
            fmap = data("ssd_map_%d" % k, [w["ssd_batch"], c, side, side])
            heads.append(L.conv2d(input=fmap, num_filters=priors * 4,
                                  filter_size=3, padding=1,
                                  param_attr=fluid.ParamAttr(
                                      name="ssd_loc_%d.w" % k),
                                  bias_attr=False))
        fused("fusion_transpose_flatten_concat", {"X": heads}, {"Out": 1},
              {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
               "concat_axis": 1})
        # GoogLeNet's inception (3a) input through its four filters
        ix = data("inc_x", [w["inc_batch"], w["inc_in"], w["inc_side"],
                            w["inc_side"]])
        fused("conv2d_inception_fusion", {
            "Input": [ix],
            "Filter": [_param(fluid, "inc_%d.w" % k, [o, w["inc_in"], s, s])
                       for k, (o, s) in enumerate(w["inc_filters"])],
            "Bias": [_param(fluid, "inc_%d.b" % k, [o], bias=True)
                     for k, (o, _) in enumerate(w["inc_filters"])]},
            {"Output": 1})
        # attention_lstm at the stacked LSTM's widths
        b, t, m, d = w["att_batch"], w["att_t"], w["att_m"], w["att_d"]
        ax = data("att_x", [b, t, m])
        alen = data("att_x@LEN", [b], "int64")
        c0 = data("att_c0", [b, d])
        fused("attention_lstm", {
            "X": [ax], "C0": [c0], "Length": [alen],
            "AttentionWeight": [_param(fluid, "att.aw", [m + d, 1])],
            "AttentionBias": [_param(fluid, "att.ab", [1, 1], bias=True)],
            "AttentionScalar": [_param(fluid, "att.as", [1, 1])],
            "AttentionScalarBias": [_param(fluid, "att.asb", [1, 1],
                                           bias=True)],
            "LSTMWeight": [_param(fluid, "att.lw", [d + m, 4 * d])],
            "LSTMBias": [_param(fluid, "att.lb", [1, 4 * d], bias=True)]},
            {"Hidden": 1, "Cell": 1, "AttentionedX": 1},
            {"gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh"})
        terms = [L.reduce_mean(v) for vs in outs.values() for v in vs]
        loss = L.sums(terms)
        fluid.optimizer.SGD(learning_rate=w["lr"]).minimize(loss)
    feeds = ["ffn_x", "gru_x", "gru_x@LEN", "conv_x", "conv_x@LEN",
             "expand_seq", "expand_a", "expand_b"] + \
        ["ssd_map_%d" % k for k in range(len(w["ssd_heads"]))] + \
        ["inc_x", "att_x", "att_x@LEN", "att_c0"]
    return Model(main, startup, loss, None, feeds,
                 {"widths": w, "outputs": outs})


def chain_batch(seed, **widths):
    """N(0, 1) activations (uniform [0, 1) feature maps and inception
    input), lengths uniform in [1, T] with the longest row at T (the
    sentiment reviews' lengths cut at 256), attention's C0 N(0, 1)."""
    w = dict(CHAIN, **widths)
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    def lens(b, t):
        n = rng.randint(1, t + 1, (b,)).astype(np.int64)
        n[0] = t
        return n
    out = {"ffn_x": randn(w["ffn_rows"], w["ffn_in"]),
           "gru_x": randn(w["gru_batch"], w["gru_t"], w["gru_in"]),
           "gru_x@LEN": lens(w["gru_batch"], w["gru_t"]),
           "conv_x": randn(w["conv_batch"], w["conv_t"], w["conv_emb"]),
           "conv_x@LEN": lens(w["conv_batch"], w["conv_t"]),
           "expand_seq": randn(w["expand_batch"], w["expand_t"],
                               w["expand_seq"]),
           "expand_a": randn(w["expand_batch"], w["expand_vec"]),
           "expand_b": randn(w["expand_batch"], w["expand_vec"]),
           "inc_x": rng.rand(w["inc_batch"], w["inc_in"], w["inc_side"],
                             w["inc_side"]).astype(np.float32),
           "att_x": randn(w["att_batch"], w["att_t"], w["att_m"]),
           "att_x@LEN": lens(w["att_batch"], w["att_t"]),
           "att_c0": randn(w["att_batch"], w["att_d"])}
    for k, (c, side, _) in enumerate(w["ssd_heads"]):
        out["ssd_map_%d" % k] = rng.rand(w["ssd_batch"], c, side,
                                         side).astype(np.float32)
    return out


# name -> (build function, batch, narrow widths) of the training programs
PROGRAMS = {
    "fused_stacked_lstm": (fused_stacked_lstm, stacked_batch, STACKED_NARROW),
    "stacked_lstm": (stacked_lstm, stacked_batch, STACKED_NARROW),
    "fused_ctr": (fused_ctr, ctr_batch, CTR_NARROW),
    "ctr": (ctr, ctr_batch, CTR_NARROW),
    "fusion_chain": (fusion_chain, chain_batch, CHAIN_NARROW),
}
