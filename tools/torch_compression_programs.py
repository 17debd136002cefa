"""The model-compression and chunk-evaluation programs, built on whichever
``fluid`` module the caller passes: the port's (``paddle_tpu_torch.fluid``)
or the JAX package's (``paddle_tpu.fluid``). The same code gives the same
program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.qat_resnet(fluid, **tool.QAT_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.qat_batch(0, **tool.QAT_NARROW),
            fetch_list=[m.loss])

Each program function returns ``Model(main, startup, loss, out,
feeds, extra)``.
Every program is float32, with random weights from the startup's seed and
seeded synthetic data: the ImageNet and conll05 files are not in the
repository, so no accuracy, and no accuracy lost to quantization, is
measured.

- ``qat_resnet``: quantization-aware training of ResNet-50 from the
  package's ``models/resnet.py`` (``resnet_imagenet``, depth 50, 3 x 224
  x 224, 1,000 classes; PaddlePaddle/models' ResNet-50 as
  ``benchmark/fluid/models/resnet.py`` builds it), batch 64, softmax
  cross-entropy, Momentum(0.01, 0.9). ``QuantizeTranspiler(weight_bits=8,
  activation_bits=8).training_transpile`` runs before ``minimize`` (``bits``
  8; FINE_BITS gives the variant that two devices' whole runs are
  compared at), as the
  JAX package's tests/test_contrib_and_bert.py orders them: one
  ``fake_quantize_dequantize_abs_max`` round trip on each distinct input
  and weight of the 53 conv2d and the 1 mul (a block's first conv and its
  shortcut share theirs): 104 (``extra["round_trips"]``).
  ``extra["transpiler"]`` freezes it (``freeze_program``: the test-mode
  clone); ``infer_program(fluid, m)`` is that clone pruned to the logits,
  which the int8 ``Calibrator`` samples over ``calib_batches`` batches of
  ``calib_batch`` images (``calib_batch``: the cut, 8 images, because
  ``sample_data`` brings up to 256 activations to the host a batch) and
  saves with int8 weights.
- ``slim_resnet``: ``slim.merge`` of a ResNet-101 teacher (the same
  module's ``_DEPTH[101]``, in test mode: its batch norms read their
  running statistics) into a ResNet-50 student, both at 224, batch 32; the
  merged program trains the student on ``soft_label_loss`` of the logits
  (temperatures 2) plus ``fsp_loss`` over one pair of stage outputs (the
  first max pool's output and the first stage's, 64 and 256 channels at
  56 x 56, in both nets) with Momentum(0.01, 0.9). The student's startup
  also initializes the teacher, its ops writing the merged names
  (``extra["rename"]``), where a pretrained teacher would be loaded.
  ``extra["student_params"]`` names what ``PruneStrategy`` (ratio 0.5)
  prunes through ``Compressor.run`` over a reader of ``reader_batches``
  batches.
- ``srl_chunk_eval``: tools/torch_decode_programs.py's
  ``book_label_semantic_roles`` at its book widths and its tagging
  program (``srl_tagger``), whose crf_decoding tags ``chunk_eval`` scores
  against the target (scheme IOB, ``num_chunk_types`` =
  ceil((label_dict - 1) / 2) = 29: conll05's 58 B- and I- tags and O)
  through ``evaluator.ChunkEvaluator``, the [B, T] tags unsqueezed to
  the target's [B, T, 1] (chunk_eval squeezes its Label only when its
  Inference is 3-D, in both packages); ``extra["counts"]`` are the
  chunk_eval op's three counts, which ``metrics.ChunkEvaluator`` takes,
  ``extra["tagger"]`` the request program (a ``Model``: its startup
  initializes the evaluator's states). Like the book's, the layer passes
  no Length: each padded tail is scored as tags (ROADMAP Queue 3).
- ``compression_chain``: every lowering the three programs do not run,
  each at a shape its source uses, with SGD(1e-3) where a gradient exists:
  ResNet-50's res2 activation (batch 64: 64 x 256 x 56 x 56, ReLU'd,
  scaled by a per-channel parameter) through ``fake_quantize_abs_max``
  and ``fake_dequantize_max_abs``, and through the moving-average (rate
  0.9) and range abs-max ops with an ``InScale`` state each (the training
  op writes its state back, an ``is_test`` op after it reads it);
  ``fake_channel_wise_quantize_abs_max`` and its dequantize (one scale an
  output channel) over six of ResNet-50's conv filter shapes, the last
  also dequantized by the activation's scale; ``quantize`` (scale 32) ->
  ``requantize`` (to 16) -> ``dequantize`` on a ReLU'd activation on the
  int8 grid's half steps; ``hash`` (num_hash 2, mod 100,000) over DeepFM's
  26 id fields (batch 4,096), whose buckets ``lookup_sparse_table`` reads
  from DeepFM's [100,000, 10] table; ``positive_negative_pair`` over those
  rows' means for 4,096 examples in 64 query groups;
  ``split_selected_rows``, ``split_byref`` (4 parameter servers) and
  ``ref_by_trainer_id`` over the table; ``alloc_continuous_space`` over
  the chain's parameters. The loss sums the means of the float outputs.
  ``boundary_values`` places activations where a quantization by the
  reciprocal of the scale rounds to the other integer.

``*_NARROW`` hold the widths of the CPU tests (the QAT program at
``resnet_cifar10`` depth 8 and 32 x 32, the distillation pair at depths
14 and 8).
"""
import collections
import importlib
import importlib.util
import math
import os

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")


def _resnet(fluid):
    """The package's models/resnet.py (the port's or the JAX package's)."""
    return importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.resnet")


def _stages(fluid, img, w, depth, is_test=False):
    """resnet_imagenet (w["dataset"] "flowers") or resnet_cifar10 at
    `depth`, op for op, also returning its first two stage boundaries:
    (logits, (the stem's output, the first stage's))."""
    R = _resnet(fluid)
    L = fluid.layers
    if w["dataset"] == "cifar10":
        n = (depth - 2) // 6
        conv1 = R.conv_bn_layer(img, 16, 3, 1, 1, is_test=is_test)
        res1 = R.layer_warp(R.basicblock, conv1, 16, n, 1, is_test)
        res2 = R.layer_warp(R.basicblock, res1, 32, n, 2, is_test)
        res3 = R.layer_warp(R.basicblock, res2, 64, n, 2, is_test)
        pool = L.pool2d(input=res3, pool_size=8, pool_type="avg",
                        global_pooling=True)
        return L.fc(input=pool, size=w["classes"]), (conv1, res1)
    cfg = R._DEPTH[depth]
    conv1 = R.conv_bn_layer(img, 64, 7, 2, 3, is_test=is_test)
    pool1 = L.pool2d(input=conv1, pool_type="max", pool_size=3,
                     pool_stride=2, pool_padding=1)
    res1 = R.layer_warp(R.bottleneck, pool1, 64, cfg[0], 1, is_test)
    res2 = R.layer_warp(R.bottleneck, res1, 128, cfg[1], 2, is_test)
    res3 = R.layer_warp(R.bottleneck, res2, 256, cfg[2], 2, is_test)
    res4 = R.layer_warp(R.bottleneck, res3, 512, cfg[3], 2, is_test)
    pool2 = L.pool2d(input=res4, pool_size=7, pool_type="avg",
                     global_pooling=True)
    return L.fc(input=pool2, size=w["classes"]), (pool1, res1)


def image_batch(seed, batch, image, classes):
    """Uniform [0, 1) images and uniform labels (bench.py's ResNet feed)."""
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, *image).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


# ---- quantization-aware ResNet-50 ------------------------------------------

QAT = dict(dataset="flowers", depth=50, image=[3, 224, 224], classes=1000,
           batch=64, calib_batch=8, calib_batches=2, bits=8)
QAT_NARROW = dict(dataset="cifar10", depth=8, image=[3, 32, 32], classes=10,
                  batch=4, calib_batch=2, calib_batches=2, bits=8)
# round trips this wide move a value that rounds the other way by 2**-23
# of its scale, below float32 noise: whole runs of two devices or two
# packages are compared at this width (at 8 bits one value an ulp from a
# half step rounds apart and moves a whole step's gradients by up to 22%)
FINE_BITS = 24
QAT_LR = 0.01
QAT_MOMENTUM = 0.9


def qat_resnet(fluid, seed=110, **widths):
    """The QAT program at `widths` (QAT's keys): main (Momentum), startup
    seeded with `seed`, the loss, ``out`` the logits; ``extra``: acc,
    transpiler, round_trips."""
    w = dict(QAT, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data(name="img", shape=w["image"], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        logits, _ = _stages(fluid, img, w, w["depth"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc = L.accuracy(input=L.softmax(logits), label=label)
        t = fluid.contrib.QuantizeTranspiler(weight_bits=w["bits"],
                                             activation_bits=w["bits"])
        t.training_transpile(main)
        fluid.optimizer.Momentum(learning_rate=QAT_LR,
                                 momentum=QAT_MOMENTUM).minimize(loss)
    trips = sum(1 for op in main.global_block().ops
                if op.type == "fake_quantize_dequantize_abs_max")
    return Model(main, startup, loss, logits, ["img", "label"],
                 {"acc": acc, "transpiler": t, "round_trips": trips})


def infer_program(fluid, m):
    """The QAT model frozen (``freeze_program``) and pruned to its logits:
    the is_test program a request, and the Calibrator, run (feed img)."""
    frozen = m.extra["transpiler"].freeze_program(m.main)
    return frozen._prune(["img"], [m.out.name])


def qat_batch(seed, **widths):
    w = dict(QAT, **widths)
    return image_batch(seed, w["batch"], w["image"], w["classes"])


def calib_batch(seed, **widths):
    """A calibration batch: calib_batch images."""
    w = dict(QAT, **widths)
    return {"img": image_batch(seed, w["calib_batch"], w["image"],
                               w["classes"])["img"]}


# ---- distillation and pruning ----------------------------------------------

SLIM = dict(dataset="flowers", teacher_depth=101, depth=50,
            image=[3, 224, 224], classes=1000, batch=32, prune_ratio=0.5,
            reader_batches=2)
SLIM_NARROW = dict(dataset="cifar10", teacher_depth=14, depth=8,
                   image=[3, 32, 32], classes=10, batch=4, prune_ratio=0.5,
                   reader_batches=2)
SLIM_LR = 0.01
SLIM_MOMENTUM = 0.9
SLIM_TEMPERATURE = 2.0


def slim_resnet(fluid, seed=111, **widths):
    """The distillation program at `widths` (SLIM's keys): main (the
    student's Momentum over the merged program), startup (the student's,
    seeded with `seed`), the loss, ``out`` the student's logits; ``extra``:
    teacher (a ``Model`` of the teacher's programs, its startup seeded with
    seed + 1; the student's startup holds its ops), rename (teacher name
    -> merged name), soft and fsp (the two
    loss terms), student_params."""
    w = dict(SLIM, **widths)
    L = fluid.layers
    slim = fluid.contrib.slim
    t_main, t_start = fluid.Program(), fluid.Program()
    t_start.random_seed = seed + 1
    with fluid.program_guard(t_main, t_start), fluid.unique_name.guard():
        timg = L.data(name="img", shape=w["image"], dtype="float32")
        t_logits, t_pair = _stages(fluid, timg, w, w["teacher_depth"],
                                   is_test=True)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data(name="img", shape=w["image"], dtype="float32")
        s_logits, s_pair = _stages(fluid, img, w, w["depth"])
    student_params = [p.name for p in main.all_parameters()]
    rename = slim.merge(t_main, main, data_name_map={"img": "img"})
    _merge_startup(t_start, startup, rename)
    block = main.global_block()
    with fluid.program_guard(main, startup), fluid.unique_name.guard(
            "distill_"):
        tvar = [block.var(rename[v.name]) for v in (t_logits,) + t_pair]
        soft = slim.soft_label_loss(tvar[0], s_logits, SLIM_TEMPERATURE,
                                    SLIM_TEMPERATURE)
        fsp = slim.fsp_loss(tvar[1], tvar[2], s_pair[0], s_pair[1])
        loss = L.elementwise_add(soft, fsp)
        fluid.optimizer.Momentum(learning_rate=SLIM_LR,
                                 momentum=SLIM_MOMENTUM).minimize(loss)
    teacher = Model(t_main, t_start, None, t_logits, ["img"], {})
    return Model(main, startup, loss, s_logits, ["img"],
                 {"teacher": teacher, "rename": rename, "soft": soft,
                  "fsp": fsp, "student_params": student_params})


def _merge_startup(t_start, startup, rename):
    """Append the teacher's startup ops to the student's, writing the
    merged names: the student's startup then initializes the teacher too
    (a pretrained teacher's values would be loaded in their place)."""
    tblock, sblock = t_start.global_block(), startup.global_block()
    for op in tblock.ops:
        for n in op.output_arg_names:
            v = tblock.var(n)
            sblock.create_var(name=rename[n], shape=v.shape, dtype=v.dtype,
                              persistable=True)
        sblock.append_op(
            type=op.type,
            inputs={k: [rename.get(n, n) for n in vs]
                    for k, vs in op.inputs.items()},
            outputs={k: [rename[n] for n in vs]
                     for k, vs in op.outputs.items()},
            attrs=dict(op.attrs))


def slim_batch(seed, **widths):
    w = dict(SLIM, **widths)
    return {"img": image_batch(seed, w["batch"], w["image"],
                               w["classes"])["img"]}


# ---- chunk evaluation of the SRL tagger ------------------------------------

def _decode_tool():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_decode_programs.py")
    spec = importlib.util.spec_from_file_location("torch_decode_programs",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


_DEC = _decode_tool()
SRL = _DEC.SRL
SRL_NARROW = _DEC.SRL_NARROW
CHUNK_SCHEME = "IOB"


def chunk_types(label_dict):
    """IOB's chunk types over label_dict labels, O among them."""
    return int(math.ceil((label_dict - 1) / 2.0))


def srl_chunk_eval(fluid, seed=45, **widths):
    """The SRL model at `widths` (SRL's keys): its training program (main,
    startup, loss, ``out`` the decoding's agreement), and in ``extra``:
    tagger (a ``Model``: the tagging program with chunk_eval and the
    evaluator's states, their startup, ``out`` the tags), evaluator,
    counts (the chunk_eval op's NumInferChunks, NumLabelChunks,
    NumCorrectChunks), chunk_types."""
    w = dict(SRL, **widths)
    m = _DEC.book_label_semantic_roles(fluid, seed=seed, **widths)
    tagger = _DEC.srl_tagger(m)
    ev_startup = fluid.Program()
    block = tagger.global_block()
    types = chunk_types(w["label_dict"])
    with fluid.program_guard(tagger, ev_startup), \
            fluid.unique_name.guard():
        tags = block.var(m.out.name)
        # crf_decoding's tags are [B, T] and the target [B, T, 1]:
        # chunk_eval squeezes its Label only when its Inference is 3-D
        ev = fluid.evaluator.ChunkEvaluator(
            input=fluid.layers.unsqueeze(tags, axes=[2]),
            label=block.var("target"), chunk_scheme=CHUNK_SCHEME,
            num_chunk_types=types)
    op, = [op for op in block.ops if op.type == "chunk_eval"]
    counts = [block.var(op.output(s)[0]) for s in (
        "NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]
    t = Model(tagger, ev_startup, None, tags, list(m.feeds), {})
    return Model(m.main, m.startup, m.loss, m.out, m.feeds,
                 {"tagger": t, "evaluator": ev, "counts": counts,
                  "chunk_types": types})


def srl_batch(seed, **widths):
    return _DEC.srl_batch(seed, **widths)


# ---- the chain of the other lowerings ---------------------------------------

CHAIN = dict(act=[64, 256, 56, 56],
             filters=[[64, 3, 7, 7], [64, 64, 3, 3], [256, 64, 1, 1],
                      [128, 256, 1, 1], [512, 512, 3, 3], [2048, 512, 1, 1]],
             q_scale=32.0, rq_scale=16.0, ids_batch=4096, fields=26,
             num_hash=2, vocab=100000, emb=10, queries=64, pservers=4,
             trainer_id=1, boundary=4096)
CHAIN_NARROW = dict(act=[2, 8, 6, 6], filters=[[4, 3, 3, 3], [8, 4, 1, 1]],
                    q_scale=32.0, rq_scale=16.0, ids_batch=16, fields=26,
                    num_hash=2, vocab=60, emb=4, queries=3, pservers=2,
                    trainer_id=1, boundary=16)
CHAIN_LR = 1e-3
CHAIN_MOVING_RATE = 0.9
# the states' first values: below the activation's max, so that both ops
# clip at first
CHAIN_MA_SCALE = 1.0
CHAIN_RANGE_SCALE = 0.5


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


def _state(fluid, name, value):
    """A persistable float32 [1] state, initialized to `value`."""
    return fluid.layers.create_global_var(shape=[1], value=value,
                                          dtype="float32", persistable=True,
                                          name=name)


def compression_chain(fluid, seed=112, **widths):
    """The chain at `widths` (CHAIN's keys): main (SGD), startup seeded
    with `seed`, the loss; ``extra`` the outputs a check reads."""
    w = dict(CHAIN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    ex = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper("compression_chain")

        def data(name, shape, dtype="float32"):
            return L.data(name=name, shape=shape, dtype=dtype,
                          append_batch_size=False)
        act = data("act", w["act"])
        grid = data("grid", w["act"])
        ids = data("ids", [w["ids_batch"], w["fields"]], "int64")
        rank_label = data("rank_label", [w["ids_batch"], 1])
        qid = data("qid", [w["ids_batch"], 1], "int64")
        trainer = data("trainer_id", [1], "int64")
        gain = L.create_parameter(
            [w["act"][1]], "float32", name="chain_gain",
            default_initializer=fluid.initializer.Constant(1.0))
        x = L.elementwise_mul(act, gain, axis=1)
        terms = []
        # per-tensor fake quantization and dequantization
        q = _append(helper, "fake_quantize_abs_max", {"X": [x]},
                    {"Out": 1, "OutScale": 1}, {"bit_length": 8})
        ex["quantized"] = q["Out"][0]
        deq = _append(helper, "fake_dequantize_max_abs",
                      {"X": q["Out"], "Scale": q["OutScale"]}, {"Out": 1},
                      {"bit_length": 8})["Out"][0]
        terms.append(deq)
        # the stateful ops, training (the state written back), then test
        for op_type, name, value in (
                ("fake_quantize_moving_average_abs_max", "chain_ma_scale",
                 CHAIN_MA_SCALE),
                ("fake_quantize_range_abs_max", "chain_range_scale",
                 CHAIN_RANGE_SCALE)):
            state = _state(fluid, name, value)
            attrs = {"bit_length": 8, "moving_rate": CHAIN_MOVING_RATE}
            out = helper.create_variable_for_type_inference("float32")
            helper.append_op(type=op_type,
                             inputs={"X": [x], "InScale": [state]},
                             outputs={"Out": [out], "OutScale": [state]},
                             attrs=attrs)
            test = _append(helper, op_type,
                           {"X": [x], "InScale": [state]},
                           {"Out": 1, "OutScale": 1},
                           dict(attrs, is_test=True))
            terms += [out, test["Out"][0]]
        # channel-wise over conv filters
        for k, shape in enumerate(w["filters"]):
            f = L.create_parameter(
                shape, "float32", name="chain_filter_%d" % k,
                default_initializer=fluid.initializer.MSRA(uniform=False))
            cq = _append(helper, "fake_channel_wise_quantize_abs_max",
                         {"X": [f]}, {"Out": 1, "OutScale": 1},
                         {"bit_length": 8})
            scales = cq["OutScale"] + (q["OutScale"] if k == len(
                w["filters"]) - 1 else [])
            terms.append(_append(
                helper, "fake_channel_wise_dequantize_max_abs",
                {"X": cq["Out"], "Scales": scales}, {"Out": 1},
                {"quant_bits": [8] * len(scales)})["Out"][0])
            ex.setdefault("channel_quantized", []).append(cq["Out"][0])
        # int8 inference ops on an activation on the half-step grid
        qa = _append(helper, "quantize", {"Input": [grid]},
                     {"Output": 1}, {"Scale": w["q_scale"]},
                     {"Output": "int8"})["Output"][0]
        rq = _append(helper, "requantize", {"Input": [qa]},
                     {"Output": 1}, {"Scale_in": w["q_scale"],
                                     "Scale_out": w["rq_scale"]})
        dq = _append(helper, "dequantize", {"Input": rq["Output"]},
                     {"Output": 1}, {"Scale": w["rq_scale"]})["Output"][0]
        ex["int8"] = qa
        terms.append(dq)
        # DeepFM's ids: hashed, looked up, ranked
        buckets = L.hash(ids, hash_size=w["vocab"], num_hash=w["num_hash"])
        ex["buckets"] = buckets
        table = L.create_parameter(
            [w["vocab"], w["emb"]], "float32", name="chain_table",
            attr=fluid.ParamAttr(name="chain_table", trainable=False),
            default_initializer=fluid.initializer.Uniform(-0.1, 0.1))
        rows = _append(helper, "lookup_sparse_table",
                       {"W": [table], "Ids": [buckets]},
                       {"Out": 1})["Out"][0]
        terms.append(rows)
        score = L.reduce_mean(L.reshape(rows, [w["ids_batch"], -1]),
                              dim=1, keep_dim=True)
        pairs = _append(helper, "positive_negative_pair",
                        {"Score": [score], "Label": [rank_label],
                         "QueryID": [qid]},
                        {"PositivePair": 1, "NegativePair": 1,
                         "NeutralPair": 1})
        ex["pairs"] = [v[0] for v in pairs.values()]
        terms += ex["pairs"]
        # the parameter-server plumbing over the table
        shard = w["vocab"] // w["pservers"]
        sections = [shard] * (w["pservers"] - 1) + \
            [w["vocab"] - shard * (w["pservers"] - 1)]
        parts = _append(helper, "split_selected_rows",
                        {"X": [table]}, {"Out": w["pservers"]},
                        {"height_sections": sections})["Out"]
        byref = _append(helper, "split_byref", {"X": [table]},
                        {"Out": w["pservers"]},
                        {"sections": sections, "axis": 0})["Out"]
        mine = _append(helper, "ref_by_trainer_id",
                       {"X": byref, "TrainerId": [trainer]},
                       {"Out": 1})["Out"][0]
        terms += [parts[-1], mine]
        params = [gain] + [main.global_block().var("chain_filter_%d" % k)
                           for k in range(len(w["filters"]))]
        fused = _append(helper, "alloc_continuous_space",
                        {"Input": params},
                        {"FusedOutput": 1, "Output": len(params)})
        terms.append(fused["FusedOutput"][0])
        loss = L.sums([L.reduce_mean(t) for t in terms])
        fluid.optimizer.SGD(learning_rate=CHAIN_LR).minimize(loss)
    return Model(main, startup, loss, deq,
                 ["act", "grid", "ids", "rank_label", "qid", "trainer_id"],
                 ex)


def boundary_values(scale, n, bits=8):
    """n float32 values below `scale` whose quantization x / scale * bnt
    rounds to one integer and x * (1 / scale) * bnt (a multiply by the
    divisor's reciprocal, as a CUDA kernel divides by a number) to the
    next: found among the few floats around each half step."""
    s = np.float32(scale)
    bnt = np.float32((1 << (bits - 1)) - 1)
    half = ((np.arange(int(bnt)) + 0.5) * np.float64(s) /
            np.float64(bnt)).astype(np.float32)
    steps = np.arange(-256, 257, dtype=np.int32)
    xs = (half.view(np.int32)[:, None] + steps[None, :]).view(np.float32)
    xs = xs[(xs > 0) & (xs < s)]
    true = np.round(np.clip(xs / s, -1, 1) * bnt)
    recip = np.round(np.clip(xs * (np.float32(1) / s), -1, 1) * bnt)
    found = np.unique(xs[true != recip])
    if found.size == 0:
        raise ValueError("no boundary value for scale %r" % scale)
    return np.resize(found, n)


def chain_batch(seed, **widths):
    """A seeded feed: ReLU'd normal activations with `boundary` of them
    at boundary_values of their max; the half-step grid activation
    (ReLU'd normals rounded to 1 / (2 q_scale)); ids uniform over 2**31
    (a few negative); ranking labels 0-2 in `queries` query groups; the
    trainer id."""
    w = dict(CHAIN, **widths)
    rng = np.random.default_rng(seed)

    def relu_normal():
        x = rng.standard_normal(w["act"], dtype=np.float32)
        return np.maximum(x, 0, out=x)
    act = relu_normal()
    flat = act.reshape(-1)
    at = rng.choice(flat.size - 1, w["boundary"], replace=False)
    flat[at] = boundary_values(flat.max(), w["boundary"])
    step = np.float32(2 * w["q_scale"])
    grid = relu_normal()
    np.round(grid * step, out=grid)
    grid /= step
    ids = rng.integers(0, 2 ** 31, (w["ids_batch"], w["fields"]))
    ids[rng.random(ids.shape) < 0.01] *= -1
    return {"act": act, "grid": grid, "ids": ids.astype(np.int64),
            "rank_label": rng.integers(0, 3, (w["ids_batch"], 1)).astype(
                np.float32),
            "qid": np.sort(rng.integers(0, w["queries"],
                                        (w["ids_batch"], 1)), 0).astype(
                np.int64),
            "trainer_id": np.array([w["trainer_id"]], np.int64)}


PROGRAMS = {"qat_resnet": (qat_resnet, qat_batch, QAT_NARROW),
            "slim_resnet": (slim_resnet, slim_batch, SLIM_NARROW),
            "srl_chunk_eval": (srl_chunk_eval, srl_batch, SRL_NARROW),
            "compression_chain": (compression_chain, chain_batch,
                                  CHAIN_NARROW)}
