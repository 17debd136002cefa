"""Programs that run the rest of the NN layers (the transposed and 3-D
convolutions, 3-D and adaptive pooling, group, data and spectral norms,
LRN, the resizes, the spatial transformer, the sequence-shaped and
pairwise layers, hsigmoid and sampled softmax), built on whichever
``fluid`` module the caller passes: the port's (``paddle_tpu_torch.fluid``)
or the JAX package's (``paddle_tpu.fluid``). The same code gives the same
program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    g = tool.dcgan(fluid, seed=1, **tool.DCGAN_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(g.startup)
    d_feed, g_feed = tool.dcgan_batch(2, **tool.DCGAN_NARROW)
    exe.run(g.d_main, feed=d_feed, fetch_list=[g.d_loss])

- ``dcgan``: DCGAN (Radford et al. 2015, arXiv:1511.06434) at the widths
  of the authors' code (soumith/dcgan.torch main.lua: nz 100, ngf = ndf =
  64, 64x64x3 images, batch 64, Adam(2e-4, beta1 0.5), convolutions
  without bias drawn N(0, 0.02), batch norm scales N(1, 0.02)): G is
  conv2d_transpose nz -> 8 ngf (4x4 from 1x1), then 4, 2, 1 ngf at stride
  2 (4x4, padding 1), each with batch norm and ReLU, then -> 3 with tanh;
  D is conv2d 3 -> ndf (leaky ReLU 0.2), then 2, 4, 8 ndf at stride 2 with
  batch norm and leaky ReLU, then -> 1 (4x4); sigmoid cross-entropy. Two
  programs over one startup, each optimizer with its ``parameter_list``,
  as tools/torch_tensor_programs.py's fc_gan.
- ``stn_digits``: a spatial transformer (Jaderberg et al. 2015,
  arXiv:1506.02025, section 4.1) in front of the book's
  recognize_digits_conv (tools/torch_book_models.py), batch 64,
  Adam(0.001): the localisation net of PyTorch's STN tutorial (conv 8@7x7,
  max pool 2, ReLU, conv 10@5x5, max pool 2, ReLU, fc 32 ReLU, fc 6 from
  the identity: weight 0, bias [1, 0, 0, 0, 1, 0]), affine_grid to the
  image's 28x28 and grid_sampler, then the book's net.
- ``word2vec_hsigmoid``: the book's word2vec (dict 2073, emb 32, hidden
  256, 5-grams, batch 100, SGD(0.001)) with its fc(dict, softmax) and
  cross_entropy replaced by hsigmoid(h, label, num_classes=dict): the
  classic word2vec head.
- ``nn_chain``: one float32 training program (Adam(1e-4)) whose loss is
  the sum of each part's mean square, at the widths of models users run
  (``CHAIN``):
  1. ResNet-50's conv2 maps [64, 256, 56, 56]: group_norm (32 groups, Wu
     and He 2018), affine_channel, lrn at AlexNet's n 5, k 2, alpha 1e-4,
     beta 0.75; fsp_matrix of the map before and after; a 2x FCN
     upsampling by conv2d_transpose (4x4, stride 2, padding 1, groups
     256, the Bilinear initializer) to 112^2; resize_bilinear back to 56^2
     (the antialiasing shrink), resize_nearest to 112^2,
     image_resize_short to 56, adaptive_pool2d avg to 7x7; and one
     depthwise_conv2d_transpose op on the normalised map.
  2. C3D's first blocks (Tran et al. 2015) on [8, 3, 16, 112, 112]: conv3d
     64@3^3 (padding 1, ReLU), pool3d max (1, 2, 2), conv3d 128@3^3 (ReLU),
     pool3d avg 2^3 at stride 2, conv3d_transpose 64@2^3 at stride 2,
     adaptive_pool3d (2, 2, 2).
  3. The dense, sequence-shaped ops: row_conv over [32, 300, 1024] with
     future context 19 (DeepSpeech 2's lookahead); im2sequence of a [64,
     128, 6, 100] feature map (scaled per channel) by [6, 1] (a CRNN's
     columns);
     bilinear_tensor_product [4096, 256] x [4096, 256] -> 128; conv_shift
     of [4096, 128] by a 3-wide softmax shift (an NTM's addressing);
     data_norm over DeepFM's 13 dense features at batch 4096; tree_conv
     over [64, 256 nodes, 128 features] with 255 edges a tree (TBCNN);
     similarity_focus of a [64, 3, 28, 28] map as the mask of a conv2d.
  4. The heads ("heads"): sampled_softmax_with_cross_entropy over
     [16384, 8192] logits (train256's vocabulary, an fc from [16384, 512])
     with customized samples (1024 a row); spectral_norm of DCGAN D's
     [512, 256, 4, 4] weight, U and V carried over the steps. And the
     heads that draw ("sampled", ``RANDOM_PARTS``): the same logits' fc
     through sampled softmax by its uniform sampler (1024 samples) and
     through sample_logits (1024) and softmax_with_cross_entropy against
     its SampledLabels.

``*_NARROW`` hold the widths of the CPU tests.
"""
import collections

import numpy as np

PROGRAMS = ("dcgan", "stn_digits", "word2vec_hsigmoid", "nn_chain")

# ---- DCGAN (soumith/dcgan.torch main.lua) --------------------------------

DCGAN = dict(nz=100, ngf=64, ndf=64, image=64, channels=3, batch=64)
DCGAN_NARROW = dict(nz=8, ngf=2, ndf=2, image=16, channels=3, batch=4)
DCGAN_LR, DCGAN_BETA1, DCGAN_STD = 2e-4, 0.5, 0.02

Gan = collections.namedtuple("Gan", "startup d_main d_loss g_main g_loss "
                                    "d_params g_params")


def _dcgan_depth(image):
    """Stride-2 layers between 4x4 and the image (4 for 64x64)."""
    return int(round(np.log2(image / 4)))


def _bn(fluid, x, name, act):
    return fluid.layers.batch_norm(
        x, act=act,
        param_attr=fluid.ParamAttr(
            name=name + ".w", initializer=fluid.initializer.Normal(
                1.0, DCGAN_STD)),
        bias_attr=fluid.ParamAttr(name=name + ".b"),
        moving_mean_name=name + ".mean", moving_variance_name=name + ".var")


def _conv_attr(fluid, name):
    return fluid.ParamAttr(name=name,
                           initializer=fluid.initializer.Normal(0.0,
                                                                DCGAN_STD))


def _generator(fluid, z, w):
    L = fluid.layers
    depth = _dcgan_depth(w["image"])
    h = L.reshape(z, [-1, w["nz"], 1, 1])
    width = w["ngf"] * 2 ** (depth - 1)
    h = L.conv2d_transpose(h, num_filters=width, filter_size=4,
                           param_attr=_conv_attr(fluid, "g_ct0.w"),
                           bias_attr=False)
    h = _bn(fluid, h, "g_bn0", "relu")
    for k in range(1, depth):
        width //= 2
        h = L.conv2d_transpose(h, num_filters=width, filter_size=4,
                               stride=2, padding=1,
                               param_attr=_conv_attr(fluid, "g_ct%d.w" % k),
                               bias_attr=False)
        h = _bn(fluid, h, "g_bn%d" % k, "relu")
    h = L.conv2d_transpose(h, num_filters=w["channels"], filter_size=4,
                           stride=2, padding=1,
                           param_attr=_conv_attr(fluid, "g_ct%d.w" % depth),
                           bias_attr=False)
    return L.tanh(h)


def _discriminator(fluid, x, w):
    L = fluid.layers
    depth = _dcgan_depth(w["image"])
    h = x
    for k in range(depth):
        h = L.conv2d(h, num_filters=w["ndf"] * 2 ** k, filter_size=4,
                     stride=2, padding=1,
                     param_attr=_conv_attr(fluid, "d_c%d.w" % k),
                     bias_attr=False)
        if k:
            h = _bn(fluid, h, "d_bn%d" % k, None)
        h = L.leaky_relu(h, alpha=0.2)
    h = L.conv2d(h, num_filters=1, filter_size=4,
                 param_attr=_conv_attr(fluid, "d_c%d.w" % depth),
                 bias_attr=False)
    return L.reshape(h, [-1, 1])


def _dcgan_params(w):
    depth = _dcgan_depth(w["image"])
    g = ["g_ct%d.w" % k for k in range(depth + 1)] + \
        ["g_bn%d.%s" % (k, s) for k in range(depth) for s in "wb"]
    d = ["d_c%d.w" % k for k in range(depth + 1)] + \
        ["d_bn%d.%s" % (k, s) for k in range(1, depth) for s in "wb"]
    return d, g


def _adam(fluid):
    return fluid.optimizer.Adam(learning_rate=DCGAN_LR, beta1=DCGAN_BETA1)


def dcgan(fluid, seed=1, **widths):
    """The D and G programs over one startup program seeded with `seed`, at
    `widths` (DCGAN's keys; DCGAN by default)."""
    w = dict(DCGAN, **widths)
    d_params, g_params = _dcgan_params(w)
    startup = fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    img = [w["channels"], w["image"], w["image"]]

    def bce(logits, value):
        target = L.fill_constant_batch_size_like(
            logits, shape=[-1, 1], dtype="float32", value=value)
        return L.mean(L.sigmoid_cross_entropy_with_logits(logits, target))

    d_prog = fluid.Program()
    with fluid.program_guard(d_prog, startup), fluid.unique_name.guard():
        real = L.data(name="real", shape=img, dtype="float32")
        z = L.data(name="z", shape=[w["nz"]], dtype="float32")
        d_loss = bce(_discriminator(fluid, real, w), 1.0) + \
            bce(_discriminator(fluid, _generator(fluid, z, w), w), 0.0)
        _adam(fluid).minimize(d_loss, parameter_list=d_params)
    g_prog = fluid.Program()
    with fluid.program_guard(g_prog, startup), fluid.unique_name.guard():
        z = L.data(name="z", shape=[w["nz"]], dtype="float32")
        g_loss = bce(_discriminator(fluid, _generator(fluid, z, w), w), 1.0)
        _adam(fluid).minimize(g_loss, parameter_list=g_params)
    return Gan(startup, d_prog, d_loss, g_prog, g_loss, d_params, g_params)


def dcgan_batch(seed, **widths):
    """One step's feeds: the D step's real images (image-shaped noise in
    [-1, 1], tanh's range) and noise z ~ N(0, 1); the G step's noise."""
    w = dict(DCGAN, **widths)
    rng = np.random.RandomState(seed)
    b = w["batch"]
    real = rng.uniform(-1, 1, (b, w["channels"], w["image"], w["image"]))
    return ({"real": real.astype("float32"),
             "z": rng.randn(b, w["nz"]).astype("float32")},
            {"z": rng.randn(b, w["nz"]).astype("float32")})


# ---- the spatial transformer on the book's digits ------------------------

STN = dict(batch=64, loc=(8, 10, 32), filters=(20, 50))
STN_NARROW = dict(batch=4, loc=(2, 3, 8), filters=(4, 6))
IDENTITY_THETA = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]

Program = collections.namedtuple("Program", "main startup loss feeds")


def _localisation(fluid, img, loc):
    """PyTorch's STN tutorial's localisation net, its last fc starting at
    the identity transform."""
    L = fluid.layers
    h = img
    for n, k in zip(loc[:2], (7, 5)):
        h = L.relu(L.pool2d(L.conv2d(h, num_filters=n, filter_size=k),
                            pool_size=2, pool_stride=2))
    h = L.fc(input=h, size=loc[2], act="relu")
    theta = L.fc(input=h, size=6,
                 param_attr=fluid.ParamAttr(
                     initializer=fluid.initializer.Constant(0.0)),
                 bias_attr=fluid.ParamAttr(
                     initializer=fluid.initializer.NumpyArrayInitializer(
                         np.array(IDENTITY_THETA, np.float32))))
    return L.reshape(theta, [-1, 2, 3])


def stn_digits(fluid, seed=1, **widths):
    """The transformer, then recognize_digits_conv's net (two
    simple_img_conv_pool, batch norm after the first, fc(10, softmax),
    cross_entropy, mean); Adam(0.001)."""
    w = dict(STN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        grid = L.affine_grid(_localisation(fluid, img, w["loc"]),
                             [w["batch"], 1, 28, 28])
        h = L.grid_sampler(img, grid)
        for k, n in enumerate(w["filters"]):
            h = fluid.nets.simple_img_conv_pool(
                input=h, filter_size=5, num_filters=n, pool_size=2,
                pool_stride=2, act="relu")
            if k == 0:
                h = L.batch_norm(h)
        pred = L.fc(input=h, size=10, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return Program(main, startup, loss, ["img", "label"])


def stn_batch(seed, batch):
    """MNIST-shaped feeds: images in [-1, 1], labels in [0, 10)."""
    rng = np.random.RandomState(seed)
    return {"img": rng.uniform(-1, 1, (batch, 1, 28, 28)).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


# ---- word2vec with hierarchical softmax ----------------------------------

W2V = dict(dict_size=2073, emb=32, hidden=256, batch=100)
W2V_NARROW = dict(dict_size=37, emb=8, hidden=16, batch=6)
W2V_N = 5


def word2vec_hsigmoid(fluid, seed=1, **widths):
    """The book's N-gram model (four is_sparse lookups of one table,
    concat, fc(hidden, sigmoid)) with hsigmoid over the dictionary's
    complete binary tree in place of its softmax; SGD(0.001)."""
    w = dict(W2V, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = [L.data(name="w%d" % i, shape=[1], dtype="int64")
                 for i in range(W2V_N)]
        embs = [L.embedding(input=x, size=[w["dict_size"], w["emb"]],
                            dtype="float32", is_sparse=True,
                            param_attr=fluid.ParamAttr(name="shared_w"))
                for x in words[:-1]]
        h = L.fc(input=L.concat(input=embs, axis=1), size=w["hidden"],
                 act="sigmoid")
        cost = L.hsigmoid(h, words[-1], num_classes=w["dict_size"],
                          param_attr=fluid.ParamAttr(name="hs.w"),
                          bias_attr=fluid.ParamAttr(name="hs.b"))
        loss = L.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.001).minimize(loss)
    return Program(main, startup, loss, ["w%d" % i for i in range(W2V_N)])


def w2v_batch(seed, batch, dict_size=W2V["dict_size"]):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, dict_size, (batch, W2V_N))
    return {"w%d" % i: words[:, i:i + 1].astype("int64")
            for i in range(W2V_N)}


# ---- nn_chain -------------------------------------------------------------

CHAIN = dict(
    # 1. ResNet-50's conv2 maps
    maps=64, channels=256, size=56, gn_groups=32,
    # 2. C3D's first blocks
    clips=8, frames=16, clip_size=112, c3d=(64, 128),
    # 3. the dense, sequence-shaped ops
    rows=32, steps=300, width=1024, context=19,
    im_maps=64, im_channels=128, im_h=6, im_w=100,
    pairs=4096, pair_dim=256, pair_out=128,
    shifts=4096, shift_dim=128, shift_width=3,
    dense_batch=4096, dense=13,
    trees=64, nodes=256, node_feat=128, tree_out=128,
    focus_maps=64, focus_size=28,
    # 4. the heads
    sm_rows=16384, sm_hidden=512, vocab=8192, samples=1024,
    sn_shape=(512, 256, 4, 4))
CHAIN_NARROW = dict(
    maps=2, channels=64, size=8, gn_groups=32,
    clips=1, frames=4, clip_size=8, c3d=(4, 6),
    rows=2, steps=7, width=8, context=3,
    im_maps=2, im_channels=3, im_h=6, im_w=5,
    pairs=6, pair_dim=5, pair_out=4,
    shifts=6, shift_dim=7, shift_width=3,
    dense_batch=6, dense=13,
    trees=2, nodes=8, node_feat=6, tree_out=4,
    focus_maps=2, focus_size=5,
    sm_rows=6, sm_hidden=8, vocab=20, samples=5,
    sn_shape=(8, 4, 2, 2))
CHAIN_LR = 1e-4
SN_POWER_ITERS = 1

Chain = collections.namedtuple("Chain", "main startup loss feeds parts")


def _ms(L, x):
    return L.reduce_mean(L.square(x))


def _append(fluid, op_type, inputs, outputs, attrs):
    """An op no layer builds (depthwise_conv2d_transpose, conv_shift,
    sample_logits):
    its output variables, by slot -> (dtype, stop_gradient)."""
    helper = fluid.layer_helper.LayerHelper(op_type)
    outs = {slot: helper.create_variable_for_type_inference(
        dtype, stop_gradient=stop) for slot, (dtype, stop) in outputs.items()}
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={s: [v] for s, v in outs.items()}, attrs=attrs)
    return outs


def _maps_part(fluid, w, memo):
    L = fluid.layers
    c = w["channels"]
    maps = L.data(name="maps", shape=[w["maps"], c, w["size"], w["size"]],
                  dtype="float32", append_batch_size=False)
    g = L.group_norm(maps, groups=w["gn_groups"])
    a = L.affine_channel(
        g, scale=L.create_parameter(
            [c], "float32", name="ac.scale",
            default_initializer=fluid.initializer.Constant(1.0)),
        bias=L.create_parameter([c], "float32", name="ac.bias",
                                default_initializer=fluid.initializer
                                .Constant(0.0)))
    n = L.lrn(a, n=5, k=2.0, alpha=1e-4, beta=0.75)
    fsp = L.fsp_matrix(maps, n)
    up = L.conv2d_transpose(
        n, num_filters=c, filter_size=4, stride=2, padding=1, groups=c,
        param_attr=fluid.ParamAttr(name="fcn.up",
                                   initializer=fluid.initializer.Bilinear()),
        bias_attr=False)
    s = w["size"]
    down = L.resize_bilinear(up, out_shape=[s, s])
    near = L.resize_nearest(down, out_shape=[2 * s, 2 * s])
    short = L.image_resize_short(near, s)
    pooled = L.adaptive_pool2d(short, 7, pool_type="avg")
    dw = L.create_parameter([c, 1, 3, 3], "float32", name="dw_t.w",
                            default_initializer=fluid.initializer.Normal(
                                0.0, 0.1))
    dwt = _append(fluid, "depthwise_conv2d_transpose",
                  {"Input": [n], "Filter": [dw]},
                  {"Output": ("float32", False)},
                  {"strides": [2, 2], "paddings": [1, 1],
                   "dilations": [1, 1], "groups": c})["Output"]
    return _ms(L, fsp) + _ms(L, pooled) + _ms(L, dwt)


def _c3d_part(fluid, w, memo):
    L = fluid.layers
    f, s = w["frames"], w["clip_size"]
    clips = L.data(name="clips", shape=[w["clips"], 3, f, s, s],
                   dtype="float32", append_batch_size=False)
    h = L.conv3d(clips, num_filters=w["c3d"][0], filter_size=3, padding=1,
                 act="relu")
    h = L.pool3d(h, pool_size=[1, 2, 2], pool_stride=[1, 2, 2])
    h = L.conv3d(h, num_filters=w["c3d"][1], filter_size=3, padding=1,
                 act="relu")
    h = L.pool3d(h, pool_size=2, pool_type="avg", pool_stride=2)
    h = L.conv3d_transpose(h, num_filters=w["c3d"][0], filter_size=2,
                           stride=2)
    return _ms(L, L.adaptive_pool3d(h, [2, 2, 2], pool_type="max"))


def _dense_part(fluid, w, memo):
    L = fluid.layers

    def data(name, shape, dtype="float32"):
        return L.data(name=name, shape=list(shape), dtype=dtype,
                      append_batch_size=False)
    seq = data("seq", [w["rows"], w["steps"], w["width"]])
    loss = _ms(L, L.row_conv(seq, future_context_size=w["context"]))
    feat = data("feat", [w["im_maps"], w["im_channels"], w["im_h"],
                         w["im_w"]])
    scale = L.create_parameter([w["im_channels"]], "float32",
                               name="crnn.scale",
                               default_initializer=fluid.initializer
                               .Constant(1.0))
    cols = L.im2sequence(L.elementwise_mul(feat, scale, axis=1),
                         filter_size=[w["im_h"], 1])
    loss = loss + _ms(L, L.fc(input=cols, size=8))
    left = data("left", [w["pairs"], w["pair_dim"]])
    right = data("right", [w["pairs"], w["pair_dim"]])
    loss = loss + _ms(L, L.bilinear_tensor_product(left, right,
                                                   size=w["pair_out"]))
    mem = data("mem", [w["shifts"], w["shift_dim"]])
    shift = L.fc(input=mem, size=w["shift_width"], act="softmax")
    shifted = _append(fluid, "conv_shift", {"X": [mem], "Y": [shift]},
                      {"Out": ("float32", False)}, {})["Out"]
    loss = loss + _ms(L, shifted)
    dense = data("dense", [w["dense_batch"], w["dense"]])
    loss = loss + _ms(L, L.fc(input=L.data_norm(dense), size=8))
    nodes = data("nodes", [w["trees"], w["nodes"], w["node_feat"]])
    edges = data("edges", [w["trees"], w["nodes"] - 1, 2], "int32")
    loss = loss + _ms(L, L.tree_conv(nodes, edges, output_size=w["tree_out"],
                                     num_filters=1))
    focus = data("focus", [w["focus_maps"], 3, w["focus_size"],
                           w["focus_size"]])
    mask = L.similarity_focus(focus, axis=1, indexes=[0, 1, 2])
    conv = L.conv2d(focus, num_filters=3, filter_size=3, padding=1)
    return loss + _ms(L, L.elementwise_mul(conv, mask))


def _logits(fluid, w, memo):
    """The LM head's logits and labels, built once for the heads parts."""
    if "logits" in memo:
        return memo["logits"]
    L = fluid.layers
    hidden = L.data(name="hidden", shape=[w["sm_rows"], w["sm_hidden"]],
                    dtype="float32", append_batch_size=False)
    label = L.data(name="next_word", shape=[w["sm_rows"], 1], dtype="int64",
                   append_batch_size=False)
    memo["logits"] = L.fc(input=hidden, size=w["vocab"]), label
    return memo["logits"]


def _heads_part(fluid, w, memo):
    """The deterministic heads: sampled softmax with customized samples,
    spectral_norm."""
    L = fluid.layers
    n, s = w["sm_rows"], w["samples"]
    logits, label = _logits(fluid, w, memo)
    custom = L.sampled_softmax_with_cross_entropy(
        logits, label, s, use_customized_samples=True,
        customized_samples=L.data(name="cs_samples", shape=[n, s + 1],
                                  dtype="int64", append_batch_size=False),
        customized_probabilities=L.data(name="cs_probs", shape=[n, s + 1],
                                        dtype="float32",
                                        append_batch_size=False))
    sn_w = L.create_parameter(list(w["sn_shape"]), "float32", name="sn.w",
                              default_initializer=fluid.initializer.Normal(
                                  0.0, DCGAN_STD))
    sn = L.spectral_norm(sn_w, dim=0, power_iters=SN_POWER_ITERS)
    return L.mean(custom) + _ms(L, sn)


def _sampled_part(fluid, w, memo):
    """The heads that draw: sampled softmax by its uniform sampler,
    sample_logits through softmax_with_cross_entropy."""
    L = fluid.layers
    s = w["samples"]
    logits, label = _logits(fluid, w, memo)
    uniform = L.sampled_softmax_with_cross_entropy(logits, label, s)
    sampled = _append(fluid, "sample_logits",
                      {"Logits": [logits], "Labels": [label]},
                      {"Samples": ("int64", True),
                       "Probabilities": ("float32", True),
                       "SampledLogits": ("float32", False),
                       "SampledLabels": ("int64", True)},
                      {"num_samples": s, "remove_accidental_hits": True,
                       "seed": 0})
    sl_loss = L.mean(L.softmax_with_cross_entropy(
        sampled["SampledLogits"], sampled["SampledLabels"]))
    return L.mean(uniform) + sl_loss


PARTS = {"maps": _maps_part, "c3d": _c3d_part, "dense": _dense_part,
         "heads": _heads_part, "sampled": _sampled_part}
# the parts whose ops draw: their samples differ between the packages and
# between the card and the CPU, so they are held by invariants
RANDOM_PARTS = ("sampled",)


def nn_chain(fluid, seed=1, parts=tuple(PARTS), **widths):
    """The parts (see the module docstring; `parts` picks some) at
    `widths` (CHAIN's keys; CHAIN by default), float32, one loss,
    Adam(1e-4), in fresh programs under a fresh unique-name counter, the
    startup seeded with `seed`."""
    w = dict(CHAIN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        memo = {}
        losses = [PARTS[p](fluid, w, memo) for p in parts]
        loss = losses[0]
        for extra in losses[1:]:
            loss = loss + extra
        fluid.optimizer.Adam(learning_rate=CHAIN_LR).minimize(loss)
    feeds = [n for n, var in main.global_block().vars.items()
             if getattr(var, "is_data", False)]
    return Chain(main, startup, loss, feeds, tuple(parts))


def tree_edges(trees, nodes, rng):
    """`trees` random trees of `nodes` nodes as EdgeSet [trees, nodes - 1,
    2]: node k's parent drawn among 0 .. k - 1."""
    child = np.arange(1, nodes)
    parent = (rng.random_sample((trees, nodes - 1)) * child).astype(np.int32)
    return np.stack([parent, np.broadcast_to(child, parent.shape)],
                    axis=-1).astype(np.int32)


def chain_batch(seed, parts=tuple(PARTS), **widths):
    """A seeded batch of nn_chain's feeds at `widths` (the parts'
    `parts`): activations N(0, 1), DeepFM's dense features positive,
    customized samples with the label first and probabilities 1 / vocab."""
    w = dict(CHAIN, **widths)
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    feed = {}
    if "maps" in parts:
        feed["maps"] = randn(w["maps"], w["channels"], w["size"], w["size"])
    if "c3d" in parts:
        feed["clips"] = randn(w["clips"], 3, w["frames"], w["clip_size"],
                              w["clip_size"])
    if "dense" in parts:
        feed.update(
            seq=randn(w["rows"], w["steps"], w["width"]),
            feat=randn(w["im_maps"], w["im_channels"], w["im_h"], w["im_w"]),
            left=randn(w["pairs"], w["pair_dim"]),
            right=randn(w["pairs"], w["pair_dim"]),
            mem=randn(w["shifts"], w["shift_dim"]),
            dense=np.abs(randn(w["dense_batch"], w["dense"])) * 10,
            nodes=randn(w["trees"], w["nodes"], w["node_feat"]),
            edges=tree_edges(w["trees"], w["nodes"], rng),
            focus=randn(w["focus_maps"], 3, w["focus_size"],
                        w["focus_size"]))
    if "heads" in parts or "sampled" in parts:
        n, v, s = w["sm_rows"], w["vocab"], w["samples"]
        label = rng.randint(0, v, (n, 1)).astype(np.int64)
        feed.update(hidden=randn(n, w["sm_hidden"]), next_word=label)
        if "heads" in parts:
            feed.update(
                cs_samples=np.concatenate(
                    [label, rng.randint(0, v, (n, s))], 1).astype(np.int64),
                cs_probs=np.full((n, s + 1), 1.0 / v, np.float32))
    return feed
