"""Programs that run the tensor layers and the initializers, built on
whichever ``fluid`` module the caller passes: the port's
(``paddle_tpu_torch.fluid``) or the JAX package's (``paddle_tpu.fluid``).
The same code gives the same program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    c = tool.tensor_chain(fluid, seed=1, **tool.NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(c.startup)
    exe.run(c.main, feed=tool.chain_batch(2, **tool.NARROW),
            fetch_list=[c.loss])

- ``fc_gan``: examples/fc_gan.py's discriminator and generator programs
  over one startup program, at the example's widths (noise 16, data 32,
  fc 64, batch 32, Adam(2e-3)); each optimizer's ``parameter_list`` keeps
  its step off the other net's parameters. Copied from the example, with
  the startup program seeded; ``gan_batch`` draws the example's feeds.
- ``tensor_chain``: one training program (Adam(1e-4), as bench.py's
  Transformer trains) whose three parts put the tensor layers on the
  gradient path as models use them, at the widths of models the port
  trains (``CHAIN``):
  1. heads at train256's width (batch 256, seq 256, d_model 512, 8
     heads): an fc, split into heads, stack, unstack and concat; reverse
     on time, pad time by (0, 8) and crop back; unsqueeze, squeeze and
     expand of a per-sequence summary; multiplex of the two branches by
     a per-row id;
  2. BERT-base's masked-LM gather (256 sequences of 128, width 768, 20
     positions a sequence, repeats among them): the encoder's last fc,
     gather, an fc, and scatter back into a zero [32768, 768] tensor, with
     overwrite=False and with overwrite=True;
  3. ResNet-50's conv2 maps ([64, 256, 56, 56]): a per-channel scale,
     pad2d (reflect 1), conv2d 3x3, shuffle_channel(4), space_to_depth(2)
     to [64, 1024, 28, 28], pad_constant_like and crop.
  The loss is the sum of each part's mean square, in float32.
- ``init_zoo``: a startup program with one parameter for each of the
  four initializers at the shapes of the port's models: TruncatedNormal
  (0, 0.02) on train256's [8192, 512] embedding, MSRA uniform and normal
  on ResNet-50's last-stage [512, 512, 3, 3] filter, Bilinear on a [256,
  256, 4, 4] 2x upsampling filter, NumpyArrayInitializer with train256's
  sinusoid table [256, 512] and with an int32 table.

``NARROW`` holds the widths of the CPU tests.
"""
import collections

import numpy as np

PROGRAMS = ("fc_gan", "tensor_chain", "init_zoo")

# examples/fc_gan.py
NOISE, DIM, GAN_HIDDEN, GAN_BATCH, GAN_LR = 16, 32, 64, 32, 2e-3
D_PARAMS = ["d_fc1.w", "d_fc1.b", "d_fc2.w", "d_fc2.b"]
G_PARAMS = ["g_fc1.w", "g_fc1.b", "g_fc2.w", "g_fc2.b"]
GAN_TARGET_MEAN = 0.7

Gan = collections.namedtuple("Gan", "startup d_main d_loss g_main g_loss")


def _generator(fluid, z):
    h = fluid.layers.fc(input=z, size=GAN_HIDDEN, act="relu",
                        param_attr=fluid.ParamAttr(name="g_fc1.w"),
                        bias_attr=fluid.ParamAttr(name="g_fc1.b"))
    return fluid.layers.fc(input=h, size=DIM, act="tanh",
                           param_attr=fluid.ParamAttr(name="g_fc2.w"),
                           bias_attr=fluid.ParamAttr(name="g_fc2.b"))


def _discriminator(fluid, x):
    h = fluid.layers.fc(input=x, size=GAN_HIDDEN, act="relu",
                        param_attr=fluid.ParamAttr(name="d_fc1.w"),
                        bias_attr=fluid.ParamAttr(name="d_fc1.b"))
    return fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(name="d_fc2.w"),
                           bias_attr=fluid.ParamAttr(name="d_fc2.b"))


def fc_gan(fluid, seed=1, d_parameter_list=D_PARAMS):
    """The example's D and G programs over one startup program seeded with
    `seed`. `d_parameter_list` is the D optimizer's parameter_list (None
    lets the D step move every parameter: a control)."""
    startup = fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    d_prog = fluid.Program()
    with fluid.program_guard(d_prog, startup), fluid.unique_name.guard():
        real = L.data(name="real", shape=[DIM], dtype="float32")
        z = L.data(name="z", shape=[NOISE], dtype="float32")
        d_real = _discriminator(fluid, real)
        d_fake = _discriminator(fluid, _generator(fluid, z))
        ones = L.fill_constant_batch_size_like(
            d_real, shape=[-1, 1], dtype="float32", value=1.0)
        zeros = L.fill_constant_batch_size_like(
            d_fake, shape=[-1, 1], dtype="float32", value=0.0)
        d_loss = L.mean(L.sigmoid_cross_entropy_with_logits(d_real, ones)) + \
            L.mean(L.sigmoid_cross_entropy_with_logits(d_fake, zeros))
        fluid.optimizer.Adam(learning_rate=GAN_LR).minimize(
            d_loss, parameter_list=d_parameter_list)
    g_prog = fluid.Program()
    with fluid.program_guard(g_prog, startup), fluid.unique_name.guard():
        z = L.data(name="z", shape=[NOISE], dtype="float32")
        d_on_g = _discriminator(fluid, _generator(fluid, z))
        ones = L.fill_constant_batch_size_like(
            d_on_g, shape=[-1, 1], dtype="float32", value=1.0)
        g_loss = L.mean(L.sigmoid_cross_entropy_with_logits(d_on_g, ones))
        fluid.optimizer.Adam(learning_rate=GAN_LR).minimize(
            g_loss, parameter_list=G_PARAMS)
    return Gan(startup, d_prog, d_loss, g_prog, g_loss)


def gan_batch(seed, batch=GAN_BATCH):
    """One step's feeds, drawn as the example draws them: (the D step's
    real samples, a blob at 0.7, and noise; the G step's noise)."""
    rng = np.random.RandomState(seed)
    real = np.clip(GAN_TARGET_MEAN + 0.1 * rng.randn(batch, DIM), -1, 1)
    z_d = rng.uniform(-1, 1, (batch, NOISE))
    z_g = rng.uniform(-1, 1, (batch, NOISE))
    return ({"real": real.astype("float32"), "z": z_d.astype("float32")},
            {"z": z_g.astype("float32")})


# tensor_chain's widths: heads at train256's (bench.py's CFG), the
# masked-LM gather at BERT-base's, the maps at ResNet-50's conv2 stage
CHAIN = dict(batch=256, seq=256, d_model=512, heads=8, time_pad=8,
             mlm_seqs=256, mlm_len=128, hidden=768, masked=20,
             maps=64, channels=256, size=56, groups=4, block=2)
NARROW = dict(batch=2, seq=6, d_model=16, heads=4, time_pad=3,
              mlm_seqs=3, mlm_len=8, hidden=16, masked=5,
              maps=2, channels=8, size=6, groups=4, block=2)
CHAIN_LR = 1e-4

Chain = collections.namedtuple("Chain", "main startup loss feeds")


def _mean_square(L, x):
    return L.reduce_mean(L.square(L.cast(x, "float32")))


def tensor_chain(fluid, seed=1, dtype="bfloat16", **widths):
    """The three parts (see the module docstring) at `widths` (CHAIN's
    keys; CHAIN by default) in `dtype`, one loss, Adam(1e-4), in fresh
    programs under a fresh unique-name counter, the startup seeded with
    `seed`."""
    w = dict(CHAIN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        # 1. heads
        b, t, d = w["batch"], w["seq"], w["d_model"]
        x = L.data(name="x", shape=[b, t, d], dtype=dtype,
                   append_batch_size=False)
        h = L.fc(input=x, size=d, num_flatten_dims=2)
        heads = L.split(h, w["heads"], dim=-1)
        merged = L.concat(L.unstack(L.stack(heads, axis=1), axis=1), axis=-1)
        padded = L.pad(L.reverse(merged, axis=1),
                       [0, 0, 0, w["time_pad"], 0, 0])
        seqs = L.crop(padded, shape=[b, t, d],
                      offsets=[0, w["time_pad"] // 2, 0])
        summary = L.reduce_mean(seqs, dim=1, keep_dim=True)
        spread = L.expand(L.squeeze(L.unsqueeze(summary, [1]), [1]),
                          [1, t, 1])
        branch = L.data(name="branch", shape=[b * t, 1], dtype="int32",
                        append_batch_size=False)
        rows = L.multiplex([L.reshape(seqs, [b * t, d]),
                            L.reshape(spread, [b * t, d])], branch)
        loss = _mean_square(L, rows)
        # 2. the masked-LM gather
        n, hid = w["mlm_seqs"] * w["mlm_len"], w["hidden"]
        enc = L.fc(input=L.data(name="enc", shape=[n, hid], dtype=dtype,
                                append_batch_size=False), size=hid)
        pos = L.data(name="mlm_pos", shape=[w["mlm_seqs"] * w["masked"], 1],
                     dtype="int64", append_batch_size=False)
        picked = L.fc(input=L.gather(enc, pos), size=hid)
        zeros = L.fill_constant([n, hid], dtype, 0.0)
        loss = loss + _mean_square(L, L.scatter(zeros, pos, picked,
                                                overwrite=False)) + \
            _mean_square(L, L.scatter(zeros, pos, picked, overwrite=True))
        # 3. the maps
        c, s, g, k = w["channels"], w["size"], w["groups"], w["block"]
        maps = L.data(name="maps", shape=[w["maps"], c, s, s], dtype=dtype,
                      append_batch_size=False)
        scale = L.create_parameter(
            [c], dtype, name="maps_scale",
            default_initializer=fluid.initializer.Constant(1.0))
        conv = L.conv2d(L.pad2d(L.elementwise_mul(maps, scale, axis=1),
                                [1, 1, 1, 1], mode="reflect"),
                        num_filters=c, filter_size=3, bias_attr=False)
        deep = L.space_to_depth(L.shuffle_channel(conv, g), k)
        frame = L.fill_constant([w["maps"], c * k * k, s // k + 2,
                                 s // k + 2], dtype, 0.0)
        framed = L.pad_constant_like(frame, deep, pad_value=0.5)
        loss = loss + _mean_square(L, L.crop(
            framed, shape=[w["maps"], c * k * k, s // k, s // k],
            offsets=[0, 0, 1, 1]))
        fluid.optimizer.Adam(learning_rate=CHAIN_LR).minimize(loss)
    return Chain(main, startup, loss, ["x", "branch", "enc", "mlm_pos",
                                       "maps"])


def chain_batch(seed, **widths):
    """A seeded batch of tensor_chain's feeds at `widths`, float32 (the
    executor casts them to the program's dtype): each sequence's masked
    positions drawn with replacement, so positions repeat."""
    w = dict(CHAIN, **widths)
    rng = np.random.default_rng(seed)
    randn = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    b, t = w["batch"], w["seq"]
    pos = rng.integers(0, w["mlm_len"], (w["mlm_seqs"], w["masked"])) + \
        w["mlm_len"] * np.arange(w["mlm_seqs"])[:, None]
    return {"x": randn(b, t, w["d_model"]),
            "branch": rng.integers(0, 2, (b * t, 1)).astype("int32"),
            "enc": randn(w["mlm_seqs"] * w["mlm_len"], w["hidden"]),
            "mlm_pos": pos.reshape(-1, 1).astype("int64"),
            "maps": randn(w["maps"], w["channels"], w["size"], w["size"])}


# init_zoo's parameters: name -> (shape, dtype)
ZOO = {"trunc_normal": ([8192, 512], "float32"),
       "msra_uniform": ([512, 512, 3, 3], "float32"),
       "msra_normal": ([512, 512, 3, 3], "float32"),
       "bilinear": ([256, 256, 4, 4], "float32"),
       "sinusoid": ([256, 512], "float32"),
       "int_table": ([64, 128], "int32")}
TRUNC_STD = 0.02

Zoo = collections.namedtuple("Zoo", "main startup values")


def sinusoid_table(seq, width):
    """The Transformer's position table [seq, width]: sines of pos /
    10000^(i / (width / 2)) in the first half, cosines in the second
    (add_position_encoding's table)."""
    half = width // 2
    pos = np.arange(seq, dtype=np.float64)[:, None]
    div = np.power(10000.0, np.arange(half, dtype=np.float64) / half)
    return np.concatenate([np.sin(pos / div), np.cos(pos / div)],
                          axis=1).astype(np.float32)


def bilinear_filter(shape):
    """The filter Bilinear gives a [C, C, k, k] parameter: the kernel
    (1 - |i - c| / f)(1 - |j - c| / f), f = ceil(k / 2), c the kernel's
    centre, on each channel's own input, zeros elsewhere."""
    k = shape[3]
    f = (k + 1) // 2
    centre = f - 1 if k % 2 else f - 0.5
    ramp = 1 - np.abs(np.arange(k) - centre) / f
    out = np.zeros(shape, np.float32)
    for ch in range(shape[0]):
        out[ch, ch] = np.outer(ramp, ramp)
    return out


def init_zoo(fluid, seed=1, shapes=None):
    """A startup program that initializes one parameter with each
    initializer (ZOO's names; `shapes` narrows them), seeded with `seed`.
    Returns (main, startup, {name: the values NumpyArrayInitializer and
    Bilinear must give})."""
    shapes = dict({n: s for n, (s, _) in ZOO.items()}, **(shapes or {}))
    I = fluid.initializer
    sin = sinusoid_table(*shapes["sinusoid"])
    ints = (np.arange(np.prod(shapes["int_table"])) - 1000).reshape(
        shapes["int_table"]).astype(np.int32)
    inits = {"trunc_normal": I.TruncatedNormal(loc=0.0, scale=TRUNC_STD),
             "msra_uniform": I.MSRA(uniform=True),
             "msra_normal": I.MSRA(uniform=False),
             "bilinear": I.Bilinear(),
             "sinusoid": I.NumpyArrayInitializer(sin),
             "int_table": I.NumpyArrayInitializer(ints)}
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        for name, init in inits.items():
            fluid.layers.create_parameter(
                shapes[name], ZOO[name][1], name=name,
                default_initializer=init)
    return Zoo(main, startup, {
        "bilinear": bilinear_filter(shapes["bilinear"]), "sinusoid": sin,
        "int_table": ints})
