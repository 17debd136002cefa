"""The CTC and index-pooling programs, built on whichever ``fluid`` module
the caller passes: the port's (``paddle_tpu_torch.fluid``) or the JAX
package's (``paddle_tpu.fluid``). The same code gives the same program on
both, op for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.crnn_ctc(fluid, **tool.CRNN_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.crnn_batch(0, **tool.CRNN_NARROW),
            fetch_list=[m.loss])

Each builder returns ``Model(main, startup, loss, out, feeds, extra)``:
``out`` the program's scoring output, ``extra`` a dict of the other
variables a caller reads. Every program is float32, with random weights
from the startup's seed and seeded synthetic data (the public datasets
are not in the repository).

- ``crnn_ctc``: PaddlePaddle/models fluid/PaddleCV/ocr_recognition's
  ``crnn_ctc_model.py`` with ``data_reader.py``'s shapes: gray images
  [1, 48, 512], 95 classes and the blank at 95; four conv_bn_pool groups
  of two 3x3 convolutions (padding 1) with batch norm and ReLU, 16, 32,
  64 and 128 channels, the first three ending in pool2d(2, max, stride
  2, ceil_mode) ([128, 6, 64]); im2sequence with a [6, 1] filter and a
  reshape to [B, 64, 768]; two fc(600, num_flatten_dims=2); a forward and
  a reverse dynamic_gru(200, candidate relu); fc([fwd, bwd], 96);
  warpctc(blank 95, norm_by_times), reduce_sum, Momentum(1e-3, 0.9) with
  L2Decay(4e-4) on every parameter; batch 32. Scoring:
  ctc_greedy_decoder and ``fluid.evaluator.EditDistance`` against the
  label cast to int64 (no lengths, so each row's padding counts: ROADMAP
  Queue 3), and beside them edit_distance with both lengths, the true
  rate (``extra["distance"]``). ``crnn_decoder`` is the model's
  ``clone(for_test=True)``, taken before the optimizer, fetched for the
  decoded ids and their lengths. Initializers as the model's: the first
  convolution Normal(0, 0.0005), the other convolutions and the batch
  norms' scales Normal(0, 0.01), their biases 0, the recurrent part
  Normal(0, 0.02) and the output's bias 0. Taken where the model's value
  could not be confirmed here or the layers cannot take it: the two fc
  take no bias (the model passes its ``bias_attr_nobias``), the GRUs'
  biases keep the model's learning-rate factor 2.0, and the label is a
  dense [B, 24] batch with its lengths fed as ``label_length`` (the
  model's is an int32 LoD sequence): lengths uniform in [1, 24], padded
  with 0; T = 64 >= 2 * 24 frames, so every row is feasible. Users: OCR
  services and every CTC speech or handwriting model.
- ``segnet_basic``: SegNet-Basic (Badrinarayanan, Kendall and Cipolla,
  TPAMI 2017) at CamVid's shapes: images 3 x 352 x 480 (CamVid's 360 rows
  cut to 352, so that four 2 x 2 poolings divide), 11 classes, batch 12;
  four encoders of conv2d(64, 7, padding 3), batch norm with ReLU and
  adaptive_pool2d(half the size, require_index=True), four decoders of
  unpool(2, 2) at the matching encoder's mask, conv2d(64, 7, padding 3)
  and batch norm without ReLU; a 1 x 1 conv2d to the classes, softmax
  cross-entropy over the pixels with uniform class weights (the paper's
  median-frequency balancing is cut) and Momentum(0.1, 0.9). Scoring:
  arg_max over the classes and mean_iou(11) (``out``; ``extra`` its
  wrong and correct counts). Labels uniform over the classes. Users:
  road-scene segmentation.
- ``spp_net``: SPP-net's ZF-5 (He et al., ECCV 2014) at 224: conv1 96
  7 x 7 / 2 (padding 1) with ReLU, LRN and pool 3 / 2 (ceil_mode), conv2
  256 5 x 5 / 2 the same, conv3-5 (384, 384, 256; 3 x 3, padding 1):
  [256, 13, 13]; spp(pyramid_height=3), Paddle's power-of-two levels
  {4 x 4, 2 x 2, 1 x 1} in place of the paper's {6, 3, 2, 1} (a cut),
  5,376 features; fc 4096, fc 4096 with ReLU and dropout 0.5, fc 1000,
  softmax cross-entropy, Momentum(0.01, 0.9) with L2Decay(5e-4); batch
  64. Users: image classification at any input size.
- ``ctc_pool_chain``: every case of the slice's lowerings that the three
  models do not reach, each at a named shape: max_pool3d_with_index at
  C3D's pool1 (64 channels, 16 x 112 x 112, window 1 x 2 x 2, batch 2);
  the non-divisible adaptive pool at SegNet's uncropped fourth map (64 x
  45 x 60 -> 23 x 30, batch 12); an explicit-padding index pool at
  ResNet-50's stem pool (3 x 3 / 2, padding 1, 64 x 112 x 112, batch 8)
  and a global one at its last map (2048 x 7 x 7, batch 8); unpool at
  stride 1 < ksize 3 (repeated indices) after a 3 x 3 / 1 index pool
  (64 x 56 x 56, batch 8); spp by average at SPP-net's conv5; ctc_align
  without merging and with Length, and edit_distance with ignored_tokens,
  unnormalized, at CRNN's decode ([32, 64], labels 24); precision_recall
  over ImageNet's 1,000 classes (batch 64; built with LayerHelper, as
  it has no layer), its states accumulated in a persistable; and warpctc
  at CRNN's shapes twice: over an fc's logits, and over fed logits with
  one infeasible row (24 labels over 10 frames). The second takes no
  gradient: near -1e5 float32 spaces the log-space recursion by 0.0078,
  which moves that row's gradient by some 0.005 of its largest in either
  package, past the 1e-4 the ops are held to (the row's gradient is held
  against JAX's and float64 in tests/test_torch_ctc_pool_ops.py). Each
  pooled map is first scaled by a per-channel parameter, so that the
  pools' gradients are taken; the pool inputs are quantized to eighths,
  so that windows hold tied positive maxima. The loss sums the means of
  the float outputs; SGD(1e-3).

``*_NARROW`` hold the widths of the CPU tests (the narrow spp_net without
dropout, so that the two packages' masks do not enter a comparison).
"""
import collections

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")

# ---- CRNN-CTC ---------------------------------------------------------------

CRNN = dict(image=[1, 48, 512], channels=[16, 32, 64, 128], hidden=200,
            classes=95, max_label=24, batch=32)
CRNN_NARROW = dict(image=[1, 16, 32], channels=[2, 4, 4, 4], hidden=6,
                   classes=5, max_label=2, batch=3)
CRNN_LR = 1e-3
CRNN_MOMENTUM = 0.9
CRNN_L2 = 4e-4
CRNN_FEEDS = ["pixel", "label", "label_length"]


def crnn_frames(widths):
    """The time steps and the feature width of the sequence im2sequence
    cuts from the last map: (W / 8, channels * H / 8)."""
    w = dict(CRNN, **widths)
    _, h, wd = w["image"]
    return wd // 8, w["channels"][-1] * (h // 8)


def _normal(fluid, std, lr=1.0):
    """A new ParamAttr (a layer names the one it is given, so each
    parameter takes its own) of a Normal(0, std) initializer and the L2
    decay."""
    return fluid.ParamAttr(initializer=fluid.initializer.Normal(0.0, std),
                           regularizer=fluid.regularizer.L2Decay(CRNN_L2),
                           learning_rate=lr)


def _conv_bn_pool(fluid, x, channels, first_std, pooling):
    L = fluid.layers
    for i, c in enumerate(channels):
        std = first_std if i == 0 and first_std else 0.01
        x = L.conv2d(input=x, num_filters=c, filter_size=3, padding=1,
                     param_attr=_normal(fluid, std))
        x = L.batch_norm(input=x, act="relu", param_attr=_normal(fluid, 0.01),
                         bias_attr=_normal(fluid, 0.0))
    if pooling:
        x = L.pool2d(input=x, pool_size=2, pool_type="max", pool_stride=2,
                     ceil_mode=True)
    return x


def crnn_ctc(fluid, seed=90, **widths):
    """The CRNN-CTC recognizer's training program at `widths` (CRNN's
    keys): main (Momentum), startup seeded with `seed`, the summed CTC
    loss, ``out`` the decoded ids [B, T]; ``extra``: the decoded lengths,
    the evaluator, its distances (no lengths), the true distances (both
    lengths) and the ``for_test`` decode program."""
    w = dict(CRNN, **widths)
    t, feat = crnn_frames(w)
    ch = w["channels"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        images = L.data(name="pixel", shape=w["image"], dtype="float32")
        label = L.data(name="label", shape=[w["max_label"]], dtype="int32")
        label_len = L.data(name="label_length", shape=[1], dtype="int64")
        x = _conv_bn_pool(fluid, images, [ch[0]] * 2, 0.0005, True)
        x = _conv_bn_pool(fluid, x, [ch[1]] * 2, None, True)
        x = _conv_bn_pool(fluid, x, [ch[2]] * 2, None, True)
        x = _conv_bn_pool(fluid, x, [ch[3]] * 2, None, False)
        seq = L.im2sequence(input=x, stride=[1, 1],
                            filter_size=[w["image"][1] // 8, 1])
        seq = L.reshape(seq, [-1, t, feat])
        fc_1 = L.fc(input=seq, size=w["hidden"] * 3, num_flatten_dims=2,
                    param_attr=_normal(fluid, 0.02), bias_attr=False)
        fc_2 = L.fc(input=seq, size=w["hidden"] * 3, num_flatten_dims=2,
                    param_attr=_normal(fluid, 0.02), bias_attr=False)
        fwd = L.dynamic_gru(input=fc_1, size=w["hidden"],
                            param_attr=_normal(fluid, 0.02),
                            bias_attr=_normal(fluid, 0.02, lr=2.0),
                            candidate_activation="relu")
        bwd = L.dynamic_gru(input=fc_2, size=w["hidden"],
                            param_attr=_normal(fluid, 0.02),
                            bias_attr=_normal(fluid, 0.02, lr=2.0),
                            is_reverse=True, candidate_activation="relu")
        fc_out = L.fc(input=[fwd, bwd], size=w["classes"] + 1,
                      num_flatten_dims=2,
                      param_attr=[_normal(fluid, 0.02),
                                  _normal(fluid, 0.02)],
                      bias_attr=_normal(fluid, 0.0))
        cost = L.warpctc(input=fc_out, label=label, blank=w["classes"],
                         norm_by_times=True, label_length=label_len)
        loss = L.reduce_sum(cost)
        decoded, decoded_len = L.ctc_greedy_decoder(input=fc_out,
                                                    blank=w["classes"])
        casted = L.cast(x=label, dtype="int64")
        evaluator = fluid.evaluator.EditDistance(input=decoded, label=casted)
        distance, _ = L.edit_distance(decoded, casted,
                                      input_length=decoded_len,
                                      label_length=label_len)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=CRNN_LR,
                                 momentum=CRNN_MOMENTUM).minimize(loss)
    return Model(main, startup, loss, decoded, list(CRNN_FEEDS),
                 {"decoded_length": decoded_len, "evaluator": evaluator,
                  "eval_distances": evaluator.metrics[0],
                  "distance": distance, "decoder": test})


def crnn_decoder(model):
    """The model's ``for_test`` program pruned to the decoder: fed
    ``pixel`` alone, fetch ``model.out`` and ``extra["decoded_length"]``."""
    return model.extra["decoder"]._prune(
        ["pixel"], [model.out.name, model.extra["decoded_length"].name])


def crnn_batch(seed, **widths):
    """Images uniform in [0, 1); labels uniform over the classes, lengths
    uniform in [1, max_label], padded with 0 (``label_length`` [B, 1])."""
    w = dict(CRNN, **widths)
    rng = np.random.RandomState(seed)
    b, n = w["batch"], w["max_label"]
    pixel = rng.rand(b, *w["image"]).astype(np.float32)
    lens = rng.randint(1, n + 1, b)
    label = rng.randint(0, w["classes"], (b, n))
    label[np.arange(n)[None, :] >= lens[:, None]] = 0
    return {"pixel": pixel, "label": label.astype(np.int32),
            "label_length": lens.astype(np.int64).reshape(b, 1)}


# ---- SegNet-Basic -----------------------------------------------------------

SEGNET = dict(image=[3, 352, 480], channels=64, kernel=7, classes=11,
              batch=12)
SEGNET_NARROW = dict(image=[3, 16, 16], channels=3, kernel=7, classes=5,
                     batch=2)
SEGNET_LR = 0.1
SEGNET_MOMENTUM = 0.9
SEGNET_FEEDS = ["image", "label"]


def segnet_basic(fluid, seed=91, **widths):
    """SegNet-Basic's training program at `widths` (SEGNET's keys): main
    (Momentum), startup seeded with `seed`, the mean pixel loss, ``out``
    the mean IoU; ``extra``: the prediction [B, H, W] and mean_iou's wrong
    and correct counts."""
    w = dict(SEGNET, **widths)
    c, k = w["channels"], w["kernel"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data(name="image", shape=w["image"], dtype="float32")
        label = L.data(name="label", shape=w["image"][1:], dtype="int64")
        x, masks = img, []
        for _ in range(4):
            x = L.conv2d(input=x, num_filters=c, filter_size=k,
                         padding=k // 2)
            x = L.batch_norm(input=x, act="relu")
            h, wd = x.shape[2], x.shape[3]
            x, mask = L.adaptive_pool2d(x, [h // 2, wd // 2],
                                        require_index=True)
            masks.append(mask)
        for mask in reversed(masks):
            x = L.unpool(x, mask, ksize=[2, 2], strides=[2, 2])
            x = L.conv2d(input=x, num_filters=c, filter_size=k,
                         padding=k // 2)
            x = L.batch_norm(input=x)
        logits = L.conv2d(input=x, num_filters=w["classes"], filter_size=1)
        flat = L.reshape(L.transpose(logits, [0, 2, 3, 1]),
                         [-1, w["classes"]])
        loss = L.mean(L.softmax_with_cross_entropy(
            flat, L.reshape(label, [-1, 1])))
        pred = L.argmax(logits, axis=1)
        miou, wrong, correct = L.mean_iou(pred, label, w["classes"])
        fluid.optimizer.Momentum(learning_rate=SEGNET_LR,
                                 momentum=SEGNET_MOMENTUM).minimize(loss)
    return Model(main, startup, loss, miou, list(SEGNET_FEEDS),
                 {"pred": pred, "wrong": wrong, "correct": correct})


def segnet_batch(seed, **widths):
    """Images uniform in [0, 1), labels uniform over the classes."""
    w = dict(SEGNET, **widths)
    rng = np.random.RandomState(seed)
    b = w["batch"]
    return {"image": rng.rand(b, *w["image"]).astype(np.float32),
            "label": rng.randint(0, w["classes"],
                                 (b,) + tuple(w["image"][1:])).astype(
                                     np.int64)}


# ---- SPP-net ----------------------------------------------------------------

SPP = dict(image=[3, 224, 224], channels=[96, 256, 384, 384, 256], fc=4096,
           classes=1000, pyramid=3, dropout=0.5, batch=64)
SPP_NARROW = dict(image=[3, 80, 80], channels=[4, 8, 8, 8, 8], fc=16,
                  classes=10, pyramid=3, dropout=0.0, batch=2)
SPP_LR = 0.01
SPP_MOMENTUM = 0.9
SPP_L2 = 5e-4
SPP_FEEDS = ["image", "label"]


def spp_net(fluid, seed=92, **widths):
    """SPP-net ZF-5's training program at `widths` (SPP's keys): main
    (Momentum), startup seeded with `seed`, the mean loss, ``out`` the
    logits; ``extra``: the pyramid's features."""
    w = dict(SPP, **widths)
    ch = w["channels"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data(name="image", shape=w["image"], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        x = img
        for c, k, s, p in ((ch[0], 7, 2, 1), (ch[1], 5, 2, 0)):
            x = L.conv2d(input=x, num_filters=c, filter_size=k, stride=s,
                         padding=p, act="relu")
            x = L.lrn(x, n=5)
            x = L.pool2d(input=x, pool_size=3, pool_type="max",
                         pool_stride=2, ceil_mode=True)
        for c in ch[2:]:
            x = L.conv2d(input=x, num_filters=c, filter_size=3, padding=1,
                         act="relu")
        feats = L.spp(x, pyramid_height=w["pyramid"], pool_type="max")
        h = feats
        for _ in range(2):
            h = L.fc(input=h, size=w["fc"], act="relu")
            h = L.dropout(h, dropout_prob=w["dropout"])
        logits = L.fc(input=h, size=w["classes"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(
            learning_rate=SPP_LR, momentum=SPP_MOMENTUM,
            regularization=fluid.regularizer.L2Decay(SPP_L2)).minimize(loss)
    return Model(main, startup, loss, logits, list(SPP_FEEDS),
                 {"features": feats})


def spp_batch(seed, **widths):
    """Images uniform in [0, 1), labels uniform over the classes."""
    w = dict(SPP, **widths)
    rng = np.random.RandomState(seed)
    b = w["batch"]
    return {"image": rng.rand(b, *w["image"]).astype(np.float32),
            "label": rng.randint(0, w["classes"], (b, 1)).astype(np.int64)}


# ---- the chain of the remaining cases --------------------------------------

CHAIN = dict(pool3d=[2, 64, 16, 112, 112], adaptive=[12, 64, 45, 60],
             adaptive_out=[23, 30], padded=[8, 64, 112, 112],
             global_=[8, 2048, 7, 7], unpool=[8, 64, 56, 56],
             spp=[64, 256, 13, 13], ctc=[32, 64, 96], ctc_in=32,
             max_label=24, short=10, ignored=[1, 2], pr_classes=1000,
             pr_batch=64, pr_in=256)
CHAIN_NARROW = dict(pool3d=[1, 2, 4, 8, 8], adaptive=[1, 2, 9, 12],
                    adaptive_out=[5, 6], padded=[1, 2, 8, 8],
                    global_=[1, 4, 3, 3], unpool=[1, 2, 6, 6],
                    spp=[1, 4, 5, 5], ctc=[3, 8, 6], ctc_in=4, max_label=3,
                    short=2, ignored=[1, 2], pr_classes=7, pr_batch=5,
                    pr_in=4)
CHAIN_LR = 1e-3
CHAIN_FEEDS = ["pool3d_x", "adaptive_x", "padded_x", "global_x",
               "unpool_x", "spp_x", "ctc_x", "ctc_logits", "ctc_label",
               "ctc_frames", "ctc_label_length", "align_ids", "align_length",
               "ref", "pr_x", "pr_label"]
# the pool inputs' quantum: values k / 8, so that windows hold ties
TIE_QUANTUM = 8.0


def _scaled(fluid, x, channels):
    """x [N, C, ...] times a per-channel parameter (initially 1)."""
    L = fluid.layers
    s = L.create_parameter(
        shape=[channels], dtype="float32",
        default_initializer=fluid.initializer.Constant(1.0))
    return L.elementwise_mul(x, s, axis=1)


def _pool_with_index(fluid, op_type, x, attrs):
    helper = fluid.LayerHelper(op_type, input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]}, attrs=attrs)
    return out, mask


def ctc_pool_chain(fluid, seed=93, **widths):
    """The chain's program at `widths` (CHAIN's keys): main (SGD), startup
    seeded with `seed`, the loss, ``out`` the fc's CTC loss [B, 1];
    ``extra`` the outputs of every case by name."""
    w = dict(CHAIN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers

    def data(name, shape, dtype="float32"):
        return L.data(name=name, shape=list(shape), dtype=dtype,
                      append_batch_size=False)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ex = {}
        x = _scaled(fluid, data("pool3d_x", w["pool3d"]), w["pool3d"][1])
        ex["pool3d"], ex["pool3d_mask"] = _pool_with_index(
            fluid, "max_pool3d_with_index", x,
            {"ksize": [1, 2, 2], "strides": [1, 2, 2],
             "paddings": [0, 0, 0]})
        x = _scaled(fluid, data("adaptive_x", w["adaptive"]),
                    w["adaptive"][1])
        ex["adaptive"], ex["adaptive_mask"] = L.adaptive_pool2d(
            x, list(w["adaptive_out"]), require_index=True)
        x = _scaled(fluid, data("padded_x", w["padded"]), w["padded"][1])
        ex["padded"], ex["padded_mask"] = _pool_with_index(
            fluid, "max_pool2d_with_index", x,
            {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]})
        x = _scaled(fluid, data("global_x", w["global_"]), w["global_"][1])
        ex["global"], ex["global_mask"] = _pool_with_index(
            fluid, "max_pool2d_with_index", x,
            {"ksize": [1, 1], "global_pooling": True})
        x = _scaled(fluid, data("unpool_x", w["unpool"]), w["unpool"][1])
        pooled, mask = _pool_with_index(
            fluid, "max_pool2d_with_index", x,
            {"ksize": [3, 3], "strides": [1, 1], "paddings": [1, 1]})
        ex["unpool_mask"] = mask
        ex["unpool"] = L.unpool(pooled, mask, ksize=[3, 3], strides=[1, 1],
                                paddings=[1, 1])
        x = _scaled(fluid, data("spp_x", w["spp"]), w["spp"][1])
        ex["spp_avg"] = L.spp(x, pyramid_height=3, pool_type="avg")
        b, t, c = w["ctc"]
        label = data("ctc_label", [b, w["max_label"]], "int32")
        label_len = data("ctc_label_length", [b], "int64")
        logits = L.fc(input=data("ctc_x", [b, t, w["ctc_in"]]), size=c,
                      num_flatten_dims=2)
        ex["ctc"] = L.warpctc(input=logits, label=label, blank=c - 1,
                              label_length=label_len)
        ex["ctc_infeasible"] = L.warpctc(
            input=data("ctc_logits", [b, t, c]), label=label, blank=c - 1,
            input_length=data("ctc_frames", [b], "int64"),
            label_length=label_len)
        helper = fluid.LayerHelper("ctc_align")
        aligned = helper.create_variable_for_type_inference(
            "int64", stop_gradient=True)
        aligned_len = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
        helper.append_op(
            type="ctc_align",
            inputs={"Input": [data("align_ids", [b, t], "int64")],
                    "Length": [data("align_length", [b], "int64")]},
            outputs={"Output": [aligned], "OutputLength": [aligned_len]},
            attrs={"blank": c - 1, "merge_repeated": False})
        ex["aligned"], ex["aligned_length"] = aligned, aligned_len
        ex["distance"], _ = L.edit_distance(
            aligned, data("ref", [b, w["max_label"]], "int64"),
            normalized=False, ignored_tokens=w["ignored"],
            input_length=aligned_len)
        pr_label = data("pr_label", [w["pr_batch"], 1], "int64")
        pr_logits = L.fc(input=data("pr_x", [w["pr_batch"], w["pr_in"]]),
                         size=w["pr_classes"])
        probs, top = L.topk(L.softmax(pr_logits), k=1)
        states = L.create_global_var(
            shape=[w["pr_classes"], 4], value=0.0, dtype="float32",
            persistable=True, name="pr_states")
        helper = fluid.LayerHelper("precision_recall")
        batch_m = helper.create_variable_for_type_inference("float32")
        accum_m = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="precision_recall",
            inputs={"MaxProbs": [probs], "Indices": [top],
                    "Labels": [pr_label],
                    "StatesInfo": [states]},
            outputs={"BatchMetrics": [batch_m], "AccumMetrics": [accum_m],
                     "AccumStatesInfo": [states]},
            attrs={"class_number": w["pr_classes"]})
        ex["pr_batch"], ex["pr_accum"] = batch_m, accum_m
        floats = [ex[k] for k in ("pool3d", "adaptive", "padded", "global",
                                  "unpool", "spp_avg", "ctc",
                                  "ctc_infeasible")]
        loss = L.sums([L.mean(v) for v in floats] +
                      [L.mean(L.softmax_with_cross_entropy(pr_logits,
                                                           pr_label))])
        fluid.optimizer.SGD(learning_rate=CHAIN_LR).minimize(loss)
    return Model(main, startup, loss, ex["ctc"], list(CHAIN_FEEDS), ex)


def chain_batch(seed, **widths):
    """The chain's feeds: pool inputs normal, quantized to 1 / TIE_QUANTUM
    (ties); the fc's inputs and the fed logits normal, labels over the
    non-blank classes with lengths in [1, max_label], row 1's first two
    equal; all frames, but the fed logits' row 0: max_label labels over
    `short` frames (infeasible); ctc_align's ids over all the
    classes with lengths in [0, T]; refs with lengths in [1, max_label];
    precision_recall's inputs normal, labels over its classes."""
    w = dict(CHAIN, **widths)
    rng = np.random.RandomState(seed)

    def quantized(shape):
        return (np.round(rng.randn(*shape) * TIE_QUANTUM) /
                TIE_QUANTUM).astype(np.float32)
    b, t, c = w["ctc"]
    n = w["max_label"]
    feed = {k: quantized(w[s]) for k, s in (
        ("pool3d_x", "pool3d"), ("adaptive_x", "adaptive"),
        ("padded_x", "padded"), ("global_x", "global_"),
        ("unpool_x", "unpool"), ("spp_x", "spp"))}
    lens = rng.randint(1, n + 1, b)
    lens[0] = n
    lens[1] = max(lens[1], 2)
    frames = np.full(b, t)
    frames[0] = w["short"]
    label = rng.randint(0, c - 1, (b, n))
    label[1, 1] = label[1, 0]
    label[np.arange(n)[None, :] >= lens[:, None]] = 0
    feed.update({
        "ctc_x": rng.randn(b, t, w["ctc_in"]).astype(np.float32),
        "ctc_logits": rng.randn(b, t, c).astype(np.float32),
        "ctc_label": label.astype(np.int32),
        "ctc_frames": frames.astype(np.int64),
        "ctc_label_length": lens.astype(np.int64),
        "align_ids": rng.randint(0, c, (b, t)).astype(np.int64),
        "align_length": rng.randint(0, t + 1, b).astype(np.int64),
        "ref": rng.randint(0, c - 1, (b, n)).astype(np.int64),
        "pr_x": rng.randn(w["pr_batch"], w["pr_in"]).astype(np.float32),
        "pr_label": rng.randint(0, w["pr_classes"],
                                (w["pr_batch"], 1)).astype(np.int64)})
    return feed


PROGRAMS = {"crnn_ctc": (crnn_ctc, crnn_batch, CRNN_NARROW),
            "segnet_basic": (segnet_basic, segnet_batch, SEGNET_NARROW),
            "spp_net": (spp_net, spp_batch, SPP_NARROW),
            "ctc_pool_chain": (ctc_pool_chain, chain_batch, CHAIN_NARROW)}
