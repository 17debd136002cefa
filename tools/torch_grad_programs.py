"""Programs that take gradients with respect to their inputs, built on
whichever ``fluid`` module the caller passes: the port's
(``paddle_tpu_torch.fluid``) or the JAX package's (``paddle_tpu.fluid``).
The same code gives the same program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    g = torch_grad_programs.fgsm_digits(fluid, seed=1)
    feed = torch_grad_programs.digits_batch(64, seed=2)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(g.startup)
    exe.run(g.main, feed=feed, fetch_list=[g.loss, g.loss_adv])

Load it by file path (``importlib.util.spec_from_file_location``).

- ``fgsm_digits``: FGSM adversarial training (Goodfellow et al. 2015,
  "Explaining and Harnessing Adversarial Examples", eq. 3 and 6) of the
  Fluid book's recognize_digits_conv at the book's widths (20 and 50
  filters, 28x28, Adam(0.001); batch 64). One program a step:
  ``(dimg,) = gradients(loss, [img])``; ``adv = img + 0.1 * sign(dimg)``
  (stop_gradient); the same network on ``adv``, sharing every parameter
  and the batch norm's running statistics by name; then
  ``Adam.minimize(0.5 * loss + 0.5 * loss_adv)``. Every op of the first
  forward thus has two grad ops, and the shared parameters' gradients are
  summed.
- ``input_grads_resnet``: two input gradients over one forward of the
  package's ResNet (``resnet.build``, is_test): the FGSM direction
  ``gradients(loss, [img])``, at once turned into ``adv = img + eps *
  sign(.)``, then the class-score saliency map (Simonyan et al. 2014,
  "Deep Inside Convolutional Networks") ``gradients(logits, [img],
  target_gradients=[one_hot(label)])``. Both results are named
  ``img@GRAD``: the second overwrites the first, which ``sign`` has read
  by then, so a fetch of ``img@GRAD`` returns the saliency map.
  ``draw_bn_stats`` gives the batch norms running statistics drawn from a
  seed, as a served model has.
"""
import collections
import importlib

import numpy as np

FGSM_EPS = 0.1          # MNIST in [-1, 1]
RESNET_EPS = 8.0 / 255  # images in [0, 1)
DIGITS_FILTERS = (20, 50)
DIGITS_BATCH = 64
DIGITS_NARROW = {"filters": (4, 6)}

Fgsm = collections.namedtuple(
    "Fgsm", "main startup loss loss_adv total dimg adv feeds")
InputGrads = collections.namedtuple(
    "InputGrads", "main startup loss logits adv saliency feeds")


def _digits_net(fluid, img, filters):
    """recognize_digits_conv's network on ``img`` with every parameter and
    running statistic named, so that a second call shares them."""
    L, P = fluid.layers, fluid.ParamAttr
    h = img
    for k, n in enumerate(filters):
        h = fluid.nets.simple_img_conv_pool(
            input=h, filter_size=5, num_filters=n, pool_size=2,
            pool_stride=2, act="relu", param_attr=P(name="conv%d.w" % k),
            bias_attr=P(name="conv%d.b" % k))
        if k == 0:
            h = L.batch_norm(h, param_attr=P(name="bn.w"),
                             bias_attr=P(name="bn.b"),
                             moving_mean_name="bn.mean",
                             moving_variance_name="bn.var")
    return L.fc(input=h, size=10, act="softmax", param_attr=P(name="fc.w"),
                bias_attr=P(name="fc.b"))


def fgsm_digits(fluid, seed=1, filters=DIGITS_FILTERS, eps=FGSM_EPS):
    """The FGSM training step of recognize_digits_conv in fresh programs
    under a fresh unique-name counter, its startup seeded with ``seed``."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data(name="img", shape=[1, 28, 28], dtype="float32",
                     stop_gradient=False)
        label = L.data(name="label", shape=[1], dtype="int64")
        loss = L.mean(L.cross_entropy(input=_digits_net(fluid, img, filters),
                                      label=label))
        dimg, = fluid.gradients(loss, [img])
        adv = L.elementwise_add(img, L.scale(L.sign(dimg), scale=eps))
        adv.stop_gradient = True
        loss_adv = L.mean(L.cross_entropy(
            input=_digits_net(fluid, adv, filters), label=label))
        total = L.elementwise_add(L.scale(loss, scale=0.5),
                                  L.scale(loss_adv, scale=0.5))
        fluid.optimizer.Adam(learning_rate=0.001).minimize(total)
    return Fgsm(main, startup, loss, loss_adv, total, dimg, adv,
                ["img", "label"])


def digits_batch(batch, seed=0):
    """A seeded MNIST-shaped batch: images uniform in [-1, 1), labels 0-9."""
    rng = np.random.RandomState(seed)
    return {"img": rng.uniform(-1.0, 1.0, (batch, 1, 28, 28))
            .astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def input_grads_resnet(fluid, seed=1, eps=RESNET_EPS, **cfg):
    """The package's ResNet (``resnet.build(is_test=True, **cfg)``: flowers
    at depth 50 by default is phase inference_resnet50's program) with the
    two input gradients appended, in fresh programs under a fresh
    unique-name counter, its startup seeded with ``seed``."""
    resnet = importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.resnet")
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        _, loss, _ = resnet.build(is_test=True, **cfg)
        block = main.global_block()
        img, label = block.var("img"), block.var("label")
        img.stop_gradient = False
        logits = block.var([op for op in block.ops
                            if op.type == "softmax_with_cross_entropy"][0]
                           .input("Logits")[0])
        dimg, = fluid.gradients(loss, [img])
        adv = L.elementwise_add(img, L.scale(L.sign(dimg), scale=eps))
        adv.stop_gradient = True
        saliency, = fluid.gradients(
            logits, [img],
            target_gradients=[L.one_hot(label, depth=logits.shape[-1])])
    return InputGrads(main, startup, loss, logits, adv, saliency,
                      ["img", "label"])


def draw_bn_stats(program, seed):
    """{name: numpy value} running means N(0, 0.3^2) and variances
    U(0.5, 2) for every batch_norm of ``program``, in op order, drawn from
    ``seed`` (as tests/test_inference_transpiler.py draws them)."""
    rng = np.random.RandomState(seed)
    block = program.global_block()
    stats = {}
    for op in block.ops:
        if op.type != "batch_norm":
            continue
        n = block.var(op.input("Mean")[0]).shape[0]
        stats[op.input("Mean")[0]] = (rng.randn(n) * 0.3).astype("float32")
        stats[op.input("Variance")[0]] = rng.uniform(0.5, 2.0, n).astype(
            "float32")
    return stats
