"""ResNet (50/101/152 for ImageNet-sized input, 6n+2 for cifar10).

The port's counterpart of ``paddle_tpu/models/resnet.py``: the same
conv_bn_layer / bottleneck topology, ``build()`` signature, ops and
parameter names, so a Program built here is op-for-op identical to the JAX
package's and takes its weights. ``training_programs`` builds bench.py's
ResNet-50 leg (``Momentum(0.01, 0.9).minimize``).
"""
import numpy as np

import paddle_tpu_torch.fluid as fluid

# bench.py's RESNET_BATCH and BENCH_RESNET_DTYPE's default; the leg builds
# dataset="flowers": 3x224x224 images, 1000 classes
RESNET_BENCH_BATCH = 64
RESNET_BENCH_DTYPE = "bfloat16"


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = fluid.layers.conv2d(input=input, num_filters=ch_out,
                               filter_size=filter_size, stride=stride,
                               padding=padding, act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None, is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return fluid.layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test)
    return res_out


_DEPTH = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def resnet_imagenet(input, class_dim, depth=50, is_test=False):
    cfg = _DEPTH[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    pool1 = fluid.layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                                pool_stride=2, pool_padding=1)
    res1 = layer_warp(bottleneck, pool1, 64, cfg[0], 1, is_test)
    res2 = layer_warp(bottleneck, res1, 128, cfg[1], 2, is_test)
    res3 = layer_warp(bottleneck, res2, 256, cfg[2], 2, is_test)
    res4 = layer_warp(bottleneck, res3, 512, cfg[3], 2, is_test)
    pool2 = fluid.layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                                global_pooling=True)
    return fluid.layers.fc(input=pool2, size=class_dim)


def resnet_cifar10(input, class_dim, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test)
    pool = fluid.layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                               global_pooling=True)
    return fluid.layers.fc(input=pool, size=class_dim)


def build(dataset="cifar10", depth=50, class_dim=None, is_test=False,
          dtype="float32"):
    """Returns (feed names, avg_loss, accuracy). dtype="bfloat16" casts the
    input once so every conv, bn and fc runs in bf16 (parameters included);
    batch-norm statistics and the optimizer's velocities stay f32."""
    if dataset == "cifar10":
        dshape = [3, 32, 32]
        class_dim = class_dim or 10
        model = resnet_cifar10
        depth = 32 if depth == 50 else depth
    else:
        dshape = [3, 224, 224]
        class_dim = class_dim or 1000
        model = resnet_imagenet
    img = fluid.layers.data(name="img", shape=dshape, dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if dtype != "float32":
        img = fluid.layers.cast(img, dtype)
    logits = model(img, class_dim, depth=depth, is_test=is_test)
    if dtype != "float32":
        logits = fluid.layers.cast(logits, "float32")
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                label=label)
    return ["img", "label"], loss, acc


def training_programs(seed, **cfg):
    """Build the model with ``build``'s keywords ``cfg`` in fresh programs,
    the startup program seeded with ``seed``, and append its training step
    as bench.py's ResNet-50 leg does (``Momentum(0.01, 0.9).minimize``).
    Returns (main program, startup program, avg_loss, accuracy)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        _, loss, acc = build(**cfg)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss, acc


def synthetic_batch(batch, image_shape, class_dim, seed=0):
    """bench.py's ResNet feed: uniform [0, 1) images [batch, *image_shape]
    and labels uniform over the classes."""
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, *image_shape).astype("float32"),
            "label": rng.randint(0, class_dim, (batch, 1)).astype("int64")}
