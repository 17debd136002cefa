"""The detection programs, built on whichever ``fluid`` module the caller
passes: the port's (``paddle_tpu_torch.fluid``) or the JAX package's
(``paddle_tpu.fluid``). The same code gives the same program on both, op
for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.mobilenet_ssd(fluid, **tool.SSD_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.ssd_batch(0, **tool.SSD_NARROW),
            fetch_list=[m.loss])

Each builder returns ``Model(main, startup, loss, out, feeds, extra)``:
``out`` the program's scoring output, ``extra`` a dict of the other
variables a caller reads. Every program is float32, with random weights
from the startup's seed and seeded synthetic data: the PASCAL VOC and
COCO files are not in the repository, so no real mAP is measured.

- ``mobilenet_ssd``: PaddlePaddle/models fluid/PaddleCV/object_detection
  (``mobilenet_ssd.py``, ``train.py``'s pascalvoc settings): images
  3 x 300 x 300, 21 classes, batch 64. MobileNet-v1 (conv_bn 32 / 2, the
  13 depthwise-separable blocks on ``depthwise_conv2d`` and 1 x 1
  convolutions, each with batch norm and ReLU, convolutions MSRA-
  initialized at learning rate 0.1 and no bias), its four extra blocks
  (1 x 1 then 3 x 3 / 2: 256-512, 128-256, 128-256, 64-128), and
  ``multi_box_head`` over the six maps 19, 10, 5, 3, 2 and 1 (min sizes
  60-285, max sizes 150-300, aspect ratios [2] then [2, 3], flip, offset
  0.5): 1,917 priors. ``ssd_loss`` summed, RMSProp at piecewise_decay
  (0.001 falling to 0.5, 0.25, 0.1 and 0.01 of it at epochs 40, 60, 80
  and 100 of 16,551 images over batch 64) with L2Decay(5e-5). Ground
  truth: [B, 42, 4] boxes (VOC's most objects in an image), [B, 42, 1]
  labels and difficult flags, 1 to ``objects`` boxes an image uniform in
  size and place, classes uniform over 1-20, one in five difficult;
  padding rows hold label -1 and a box outside the image, which overlaps
  no prior (a zero box would encode as log 0). ``extra["infer"]``: the
  inference program built as ``train.py``'s test program (the same
  parameter names, ``clone(for_test=True)``: the batch norms read their
  running statistics): softmax and transpose of the confidences,
  ``detection_output`` (nms 0.45, nms_top_k 400, keep_top_k 200, score
  0.01) and ``fluid.evaluator.DetectionMAP`` (21 classes, 11point,
  overlap 0.5, difficult boxes not evaluated); ``fluid.metrics.
  DetectionMAP`` is fed what it fetches. Cuts: the reader's
  augmentation; ``train.py`` applies no softmax before
  ``detection_output`` because the reference layer applies it, and the
  JAX layer does not (ROADMAP Queue 3).
- ``faster_rcnn``: PaddlePaddle/models fluid/PaddleCV/rcnn, Faster R-CNN
  ResNet-50-C4 at COCO's shapes: one 800 x 1216 image a step (the cut:
  every image padded to one size), 81 classes, 16 ground-truth boxes (a
  fixed count: the JAX layout has no padding for rpn_target_assign's
  ground truth). Backbone conv1 and res2-res4 (3, 4, 6 bottlenecks, the
  stride on the first 1 x 1 convolution), each convolution followed by
  ``affine_channel`` (frozen batch norm: scale and bias at learning rate
  0; 1 and 0, each bottleneck's last scale BRANCH_SCALE, so that random
  weights stay finite), conv1 and res2 frozen (Detectron's FREEZE_AT 2: taken, not
  confirmed here). RPN at stride 16: conv 3 x 3 1024 with ReLU,
  ``anchor_generator`` (32-512 x {0.5, 1, 2}, variances 1), a 1 x 1
  score and box head (Normal 0.01); ``rpn_target_assign`` (256 a batch,
  fg 0.5, 0.7 / 0.3, straddle 0) with the sampled logits and deltas
  gathered by its indices (the JAX layer returns indices), sigmoid
  cross-entropy averaged over the sampled anchors and smooth L1 (sigma 3)
  over them; ``generate_proposals`` (pre 12,000, post 2,000, nms 0.7,
  min size 0); ``generate_proposal_labels`` (512 a batch, fg 0.25, fg
  0.5, bg [0, 0.5), weights 0.1 / 0.1 / 0.2 / 0.2, random); ``roi_align``
  14 x 14 at 1/16, sampling_ratio 0 (the rcnn config's value could not
  be confirmed here); the res5 head (3 bottlenecks, stride 2), average
  pooling, fc 81 (Normal 0.001) and fc 324 (Normal 0.01); softmax
  cross-entropy (padding rows ignored) and smooth L1 (sigma 1) averaged.
  Momentum 0.9 at piecewise_decay (0.01, then 0.1x at 120,000 and
  160,000; the warm-up cut) with L2Decay(1e-4). ``extra["infer"]``: the
  test program (generate_proposals 6,000 / 1,000, nms 0.7; softmax;
  ``box_coder`` decoding each class's deltas with the weights as
  variances, ``box_clip``, ``multiclass_nms`` score 0.05, nms 0.5, keep
  100). The JAX layers take one box a prior for every class, and read
  neither box_coder's axis nor multiclass_nms's background_label: each
  (RoI, class) pair is a box of its own, scored only for its class, the
  background's scores zeroed.
- ``detection_chain``: every lowering the two models do not run, each at
  a shape its source model uses, with SGD(1e-3) where a gradient exists
  (each fed map scaled by a per-channel parameter): ``yolov3_loss`` and
  ``yolo_box`` on YOLOv3's three heads at 608 (batch 8, 80 classes, its
  9 COCO anchors, masks {6, 7, 8} at stride 32, {3, 4, 5} at 16,
  {0, 1, 2} at 8, ignore 0.7, 50 gt boxes an image, conf 0.005);
  ``roi_pool`` 7 x 7 on Fast R-CNN VGG-16's conv5 map after ReLU (two
  600 x 1000 images: 512 x 37 x 62, 64 RoIs each, 1/16); ``psroi_pool``
  7 x 7 on R-FCN ResNet-101's position-sensitive map (21 classes: 1,029
  x 38 x 63, 128 RoIs, 1/16); ``density_prior_box`` at FaceBoxes'
  first anchored map (1024 image, 32 x 32, densities 4 / 2 / 1 for sizes
  32 / 64 / 128); ``polygon_box_transform`` on EAST's geometry map
  (batch 8, 512 image, 8 x 128 x 128); ``roi_perspective_transform`` of
  64 quadrilaterals to 8 x 64 on a 128 x 128 x 128 text map at 1/4 (FOTS'
  RoIRotate shape; its source could not be confirmed here);
  ``box_decoder_and_assign`` on a Cascade R-CNN stage's 512 RoIs (81
  classes, clip log(1000 / 16)); ``distribute_fpn_proposals`` of FPN's
  2,000 training proposals to levels 2-5 (refer level 4, scale 224);
  ``generate_mask_labels`` at Mask R-CNN's 14 x 14 (512 RoIs, 16 gt
  polygons of 32 vertices, 81 classes); ``anchor_generator`` at FPN's P2
  (stride 4, size 32, 200 x 304). The loss sums the means of the float
  outputs with gradients.

``*_NARROW`` hold the widths of the CPU tests (MobileNet-SSD's with one
of the five 512-channel blocks at 19 x 19, so that the JAX package
compiles its step in seconds).
"""
import collections

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")

# ---- MobileNet-SSD ----------------------------------------------------------

SSD = dict(image=[3, 300, 300], classes=21, scale=1.0, repeats=5, max_gt=42,
           objects=6, batch=64)
SSD_NARROW = dict(image=[3, 64, 64], classes=4, scale=0.125, repeats=1,
                  max_gt=5, objects=3, batch=8)
SSD_LR = 0.001
SSD_L2 = 5e-5
SSD_TRAIN_IMAGES = 16551
SSD_LR_EPOCHS = [40, 60, 80, 100]
SSD_LR_DECAY = [1, 0.5, 0.25, 0.1, 0.01]
SSD_FEEDS = ["image", "gt_box", "gt_label", "difficult"]
# mobilenet_ssd.py's head, for a 300 image
SSD_MIN_SIZES = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
SSD_MAX_SIZES = [[], 150.0, 195.0, 240.0, 285.0, 300.0]
SSD_RATIOS = [[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.], [2., 3.]]


def _conv_bn(fluid, x, filter_size, filters, stride, padding, groups=1,
             act="relu", use_cudnn=True):
    L = fluid.layers
    conv = L.conv2d(input=x, num_filters=filters, filter_size=filter_size,
                    stride=stride, padding=padding, groups=groups, act=None,
                    use_cudnn=use_cudnn, bias_attr=False,
                    param_attr=fluid.ParamAttr(
                        learning_rate=0.1,
                        initializer=fluid.initializer.MSRA()))
    return L.batch_norm(input=conv, act=act)


def _separable(fluid, x, f1, f2, groups, stride, scale):
    dw = _conv_bn(fluid, x, 3, int(f1 * scale), stride, 1,
                  groups=int(groups * scale), use_cudnn=False)
    return _conv_bn(fluid, dw, 1, int(f2 * scale), 1, 0)


def _extra(fluid, x, f1, f2, scale):
    pw = _conv_bn(fluid, x, 1, int(f1 * scale), 1, 0)
    return _conv_bn(fluid, pw, 3, int(f2 * scale), 2, 1)


def _mobilenet_ssd_head(fluid, image, w):
    """mobilenet_ssd.py's ssd_net: (locs, confs, boxes, variances)."""
    s = w["scale"]
    x = _conv_bn(fluid, image, 3, int(32 * s), 2, 1)
    for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = _separable(fluid, x, f1, f2, f1, stride, s)
    for _ in range(w["repeats"]):
        x = _separable(fluid, x, 512, 512, 512, 1, s)
    module11 = x
    x = _separable(fluid, x, 512, 1024, 512, 2, s)
    module13 = _separable(fluid, x, 1024, 1024, 1024, 1, s)
    module14 = _extra(fluid, module13, 256, 512, s)
    module15 = _extra(fluid, module14, 128, 256, s)
    module16 = _extra(fluid, module15, 128, 256, s)
    module17 = _extra(fluid, module16, 64, 128, s)
    size = w["image"][1] / 300.0
    return fluid.layers.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=image, num_classes=w["classes"], min_ratio=20, max_ratio=90,
        min_sizes=[m * size for m in SSD_MIN_SIZES],
        max_sizes=[[] if m == [] else m * size for m in SSD_MAX_SIZES],
        aspect_ratios=SSD_RATIOS, base_size=w["image"][2], offset=0.5,
        flip=True)


def _ssd_data(fluid, w):
    L = fluid.layers
    n = w["max_gt"]
    return (L.data(name="image", shape=w["image"], dtype="float32"),
            L.data(name="gt_box", shape=[n, 4], dtype="float32"),
            L.data(name="gt_label", shape=[n, 1], dtype="int32"),
            L.data(name="difficult", shape=[n, 1], dtype="int32"))


def mobilenet_ssd(fluid, seed=100, **widths):
    """MobileNet-SSD's training program at `widths` (SSD's keys): main
    (RMSProp), startup seeded with `seed`, the summed ssd_loss;
    ``extra["infer"]`` the inference program, which reads the trained
    scope's parameters (a Model: main; startup the evaluator's states,
    to run in that scope; out the detections [B, 200, 6]; extra the
    evaluator and its two mAPs)."""
    w = dict(SSD, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        image, gt_box, gt_label, _ = _ssd_data(fluid, w)
        locs, confs, box, box_var = _mobilenet_ssd_head(fluid, image, w)
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       box_var))
        iters = SSD_TRAIN_IMAGES // SSD["batch"]
        lr = L.piecewise_decay([e * iters for e in SSD_LR_EPOCHS],
                               [d * SSD_LR for d in SSD_LR_DECAY])
        fluid.optimizer.RMSProp(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(SSD_L2)).minimize(loss)
    # the network's initializers go to a startup never run (the trained
    # scope holds the parameters); the evaluator's states to its own
    infer, unused, eval_startup = (fluid.Program(), fluid.Program(),
                                   fluid.Program())
    with fluid.unique_name.guard():
        with fluid.program_guard(infer, unused):
            image, gt_box, gt_label, difficult = _ssd_data(fluid, w)
            locs, confs, box, box_var = _mobilenet_ssd_head(fluid, image, w)
            scores = L.transpose(L.softmax(confs), perm=[0, 2, 1])
            nmsed = L.detection_output(locs, scores, box, box_var,
                                       nms_threshold=0.45, nms_top_k=400,
                                       keep_top_k=200, score_threshold=0.01)
        with fluid.program_guard(infer, eval_startup):
            evaluator = fluid.evaluator.DetectionMAP(
                nmsed, gt_label, gt_box, difficult, class_num=w["classes"],
                overlap_threshold=0.5, evaluate_difficult=False,
                ap_version="11point")
    test = Model(infer.clone(for_test=True), eval_startup, None, nmsed,
                 list(SSD_FEEDS),
                 {"evaluator": evaluator, "maps": evaluator.metrics})
    return Model(main, startup, loss, None, list(SSD_FEEDS),
                 {"infer": test, "lr": lr})


def _gt_boxes(rng, b, n, count, low=0.05):
    """[b, n, 4] corner boxes inside [0, 1], 1 to `count` a row, and the
    mask of the real rows."""
    counts = rng.randint(1, count + 1, b)
    real = np.arange(n)[None, :] < counts[:, None]
    wh = rng.uniform(low, 0.6, (b, n, 2))
    lo = rng.uniform(0, 1, (b, n, 2)) * (1 - wh)
    return np.concatenate([lo, lo + wh], -1), real


def ssd_batch(seed, **widths):
    """Images uniform in [-1, 1) (the reader subtracts 127.5 and scales
    by 0.007843); ground truth as the module docstring says."""
    w = dict(SSD, **widths)
    rng = np.random.RandomState(seed)
    b, n = w["batch"], w["max_gt"]
    boxes, real = _gt_boxes(rng, b, n, w["objects"])
    boxes[~real] = [2.0, 2.0, 2.1, 2.1]               # outside the image
    label = np.where(real, rng.randint(1, w["classes"], (b, n)), -1)
    difficult = (real & (rng.rand(b, n) < 0.2)).astype(np.int32)
    return {"image": rng.uniform(-1, 1, [b] + w["image"]).astype(
                np.float32),
            "gt_box": boxes.astype(np.float32),
            "gt_label": label.astype(np.int32)[..., None],
            "difficult": difficult[..., None]}


# ---- Faster R-CNN ResNet-50-C4 ----------------------------------------------

FRCNN = dict(image=[3, 800, 1216], classes=81, gt=16, channels=64,
             depth=[3, 4, 6], head_depth=3, rpn_channels=1024,
             pre_nms=12000, post_nms=2000, test_pre_nms=6000,
             test_post_nms=1000, rpn_batch=256, roi_batch=512,
             resolution=14, use_random=True)
FRCNN_NARROW = dict(image=[3, 64, 96], classes=5, gt=3, channels=4,
                    depth=[1, 1, 1], head_depth=1, rpn_channels=8,
                    pre_nms=200, post_nms=40, test_pre_nms=100,
                    test_post_nms=24, rpn_batch=32, roi_batch=16,
                    resolution=4, use_random=False)
FRCNN_LR = 0.01
FRCNN_MOMENTUM = 0.9
FRCNN_L2 = 1e-4
FRCNN_LR_STEPS = [120000, 160000]
FRCNN_ANCHORS = [32.0, 64.0, 128.0, 256.0, 512.0]
FRCNN_RATIOS = [0.5, 1.0, 2.0]
FRCNN_REG_WEIGHTS = [0.1, 0.1, 0.2, 0.2]
FRCNN_FEEDS = ["image", "im_info", "gt_box", "gt_label", "is_crowd"]
# the frozen scale of each bottleneck's last affine_channel: with random
# weights and the folded batch norms at 1, every residual branch would
# double its sum's variance (a 79,382 first loss and NaN after one
# Momentum step at full width); a trained network's folded statistics keep
# the branches small
BRANCH_SCALE = 0.1
FRCNN_INFER_FEEDS = ["image", "im_info"]


def _frozen_affine(fluid, x, channels, scale=1.0):
    """affine_channel's scale (`scale`) and bias (0), which do not train
    (the frozen batch norm of the rcnn model)."""
    L = fluid.layers
    # a new ParamAttr each: a layer names the one it is given
    scale = L.create_parameter(
        [channels], "float32", attr=fluid.ParamAttr(learning_rate=0.0),
        default_initializer=fluid.initializer.Constant(scale))
    bias = L.create_parameter(
        [channels], "float32", attr=fluid.ParamAttr(learning_rate=0.0),
        is_bias=True, default_initializer=fluid.initializer.Constant(0.0))
    scale.stop_gradient = bias.stop_gradient = True
    return scale, bias


def _conv_affine(fluid, x, filters, size, stride, padding, act="relu",
                 scale=1.0):
    conv = fluid.layers.conv2d(input=x, num_filters=filters,
                               filter_size=size, stride=stride,
                               padding=padding, act=None, bias_attr=False)
    scale, bias = _frozen_affine(fluid, conv, filters, scale)
    return fluid.layers.affine_channel(conv, scale=scale, bias=bias, act=act)


def _bottleneck(fluid, x, filters, stride):
    L = fluid.layers
    c0 = _conv_affine(fluid, x, filters, 1, stride, 0)
    c1 = _conv_affine(fluid, c0, filters, 3, 1, 1)
    c2 = _conv_affine(fluid, c1, filters * 4, 1, 1, 0, act=None,
                      scale=BRANCH_SCALE)
    if x.shape[1] != filters * 4 or stride != 1:
        x = _conv_affine(fluid, x, filters * 4, 1, stride, 0, act=None)
    return L.elementwise_add(x=x, y=c2, act="relu")


def _stage(fluid, x, filters, count, stride):
    for k in range(count):
        x = _bottleneck(fluid, x, filters, stride if k == 0 else 1)
    return x


def _resnet_c4(fluid, image, w):
    """conv1, pool and res2-res4 (res2 and before frozen)."""
    L = fluid.layers
    c = w["channels"]
    x = _conv_affine(fluid, image, c, 7, 2, 3)
    x = L.pool2d(input=x, pool_size=3, pool_type="max", pool_stride=2,
                 pool_padding=1)
    x = _stage(fluid, x, c, w["depth"][0], 1)
    x.stop_gradient = True
    x = _stage(fluid, x, c * 2, w["depth"][1], 2)
    return _stage(fluid, x, c * 4, w["depth"][2], 2)


def _normal(fluid, std):
    return fluid.ParamAttr(initializer=fluid.initializer.Normal(0.0, std))


def _rpn(fluid, feat, w):
    L = fluid.layers
    conv = L.conv2d(input=feat, num_filters=w["rpn_channels"],
                    filter_size=3, padding=1, act="relu",
                    param_attr=_normal(fluid, 0.01))
    anchor, var = L.anchor_generator(conv, anchor_sizes=FRCNN_ANCHORS,
                                     aspect_ratios=FRCNN_RATIOS,
                                     variance=[1.0, 1.0, 1.0, 1.0],
                                     stride=[16.0, 16.0])
    a = len(FRCNN_ANCHORS) * len(FRCNN_RATIOS)
    score = L.conv2d(input=conv, num_filters=a, filter_size=1,
                     param_attr=_normal(fluid, 0.01))
    delta = L.conv2d(input=conv, num_filters=4 * a, filter_size=1,
                     param_attr=_normal(fluid, 0.01))
    return anchor, var, score, delta


def _box_head(fluid, feat, rois, w):
    """roi_align, the res5 head, average pooling, fc cls and fc box."""
    L = fluid.layers
    r = w["resolution"]
    pool = L.roi_align(input=feat, rois=rois, pooled_height=r,
                       pooled_width=r, spatial_scale=1.0 / 16.0,
                       sampling_ratio=0)
    x = _stage(fluid, pool, w["channels"] * 8, w["head_depth"], 2)
    x = L.pool2d(input=x, pool_type="avg", global_pooling=True)
    cls = L.fc(input=x, size=w["classes"], param_attr=_normal(fluid, 0.001))
    box = L.fc(input=x, size=4 * w["classes"],
               param_attr=_normal(fluid, 0.01))
    return cls, box


def _constant(var):
    """`var` with no gradient (an index or a target the losses read)."""
    var.stop_gradient = True
    return var


def _clamped(fluid, idx):
    """An index vector with its -1 padding read as row 0."""
    L = fluid.layers
    zero = L.fill_constant(shape=[1], dtype="int32", value=0)
    return _constant(L.elementwise_max(idx, zero))


def _rpn_loss(fluid, anchor, var, score, delta, gt_box, is_crowd, im_info,
              w):
    L = fluid.layers
    anchors = L.reshape(anchor, [-1, 4])
    loc_idx, score_idx, tgt_bbox, tgt_lbl, inside_w = L.rpn_target_assign(
        None, None, anchors, L.reshape(var, [-1, 4]), gt_box, is_crowd,
        im_info, rpn_batch_size_per_im=w["rpn_batch"],
        rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
        rpn_positive_overlap=0.7, rpn_negative_overlap=0.3)
    zero = L.fill_constant(shape=[1], dtype="int32", value=0)
    scores = L.reshape(L.transpose(score, perm=[0, 2, 3, 1]), [-1, 1])
    deltas = L.reshape(L.transpose(delta, perm=[0, 2, 3, 1]), [-1, 4])
    picked = L.gather(scores, _clamped(fluid, score_idx))
    sampled = _constant(L.cast(L.greater_equal(tgt_lbl, zero), "float32"))
    label = _constant(L.cast(L.elementwise_max(tgt_lbl, zero), "float32"))
    count = _constant(L.elementwise_max(
        L.reduce_sum(sampled), L.fill_constant([1], "float32", 1.0)))
    ce = L.sigmoid_cross_entropy_with_logits(
        x=L.reshape(picked, [-1]), label=label)
    cls_loss = L.reduce_sum(ce * sampled / count)
    loc = L.gather(deltas, _clamped(fluid, loc_idx))
    reg = L.smooth_l1(x=loc, y=tgt_bbox, inside_weight=inside_w,
                      outside_weight=inside_w, sigma=3.0)
    return cls_loss, L.reduce_sum(reg / count)


def faster_rcnn(fluid, seed=101, **widths):
    """Faster R-CNN's training program at `widths` (FRCNN's keys): main
    (Momentum), startup seeded with `seed`, the summed four losses;
    ``extra`` the losses, the sampled labels and ``infer`` (a Model:
    main, which reads the trained scope's parameters; an empty startup;
    out the detections [1, 100, 6])."""
    w = dict(FRCNN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        image, im_info = _frcnn_image(fluid, w)
        gt_box = L.data(name="gt_box", shape=[w["gt"], 4], dtype="float32",
                        append_batch_size=False)
        gt_label = L.data(name="gt_label", shape=[w["gt"], 1],
                          dtype="int32", append_batch_size=False)
        is_crowd = L.data(name="is_crowd", shape=[w["gt"], 1],
                          dtype="int32", append_batch_size=False)
        feat = _resnet_c4(fluid, image, w)
        anchor, var, score, delta = _rpn(fluid, feat, w)
        rois, _ = L.generate_proposals(
            L.sigmoid(score), delta, im_info, anchor, var,
            pre_nms_top_n=w["pre_nms"], post_nms_top_n=w["post_nms"],
            nms_thresh=0.7, min_size=0.0)
        rois, labels, targets, inside, outside = \
            L.generate_proposal_labels(
                rois, gt_label, is_crowd, gt_box, im_info,
                batch_size_per_im=w["roi_batch"], fg_fraction=0.25,
                fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                bbox_reg_weights=FRCNN_REG_WEIGHTS, class_nums=w["classes"],
                use_random=w["use_random"])
        cls, box = _box_head(fluid, feat, rois, w)
        labels64 = L.cast(labels, "int64")
        loss_cls = L.reduce_mean(L.softmax_with_cross_entropy(
            cls, L.reshape(labels64, [-1, 1]), ignore_index=-1,
            numeric_stable_mode=True))
        loss_box = L.reduce_mean(L.smooth_l1(
            x=box, y=targets, inside_weight=inside, outside_weight=outside,
            sigma=1.0))
        rpn_cls, rpn_reg = _rpn_loss(fluid, anchor, var, score, delta,
                                     gt_box, is_crowd, im_info, w)
        loss = L.sums([loss_cls, loss_box, rpn_cls, rpn_reg])
        lr = L.piecewise_decay(FRCNN_LR_STEPS,
                               [FRCNN_LR, FRCNN_LR * 0.1, FRCNN_LR * 0.01])
        fluid.optimizer.Momentum(
            learning_rate=lr, momentum=FRCNN_MOMENTUM,
            regularization=fluid.regularizer.L2Decay(FRCNN_L2)).minimize(
                loss)
    infer, unused = fluid.Program(), fluid.Program()
    with fluid.program_guard(infer, unused), fluid.unique_name.guard():
        image, im_info = _frcnn_image(fluid, w)
        feat = _resnet_c4(fluid, image, w)
        anchor, var, score, delta = _rpn(fluid, feat, w)
        rois, _ = L.generate_proposals(
            L.sigmoid(score), delta, im_info, anchor, var,
            pre_nms_top_n=w["test_pre_nms"],
            post_nms_top_n=w["test_post_nms"], nms_thresh=0.7, min_size=0.0)
        cls, box = _box_head(fluid, feat, rois, w)
        dets = _frcnn_detections(fluid, rois, cls, box, im_info, w)
    test = Model(infer.clone(for_test=True), fluid.Program(), None, dets,
                 list(FRCNN_INFER_FEEDS), {})
    return Model(main, startup, loss, None, list(FRCNN_FEEDS),
                 {"infer": test, "labels": labels, "losses": [
                     loss_cls, loss_box, rpn_cls, rpn_reg]})


def _frcnn_image(fluid, w):
    L = fluid.layers
    return (L.data(name="image", shape=[1] + w["image"], dtype="float32",
                   append_batch_size=False),
            L.data(name="im_info", shape=[1, 3], dtype="float32",
                   append_batch_size=False))


def _frcnn_detections(fluid, rois, cls, box, im_info, w):
    """Each class's box decoded from its RoI, clipped, and multiclass_nms
    over every (class, RoI) pair as a box of its own, scored only for its
    class (the background not at all)."""
    L = fluid.layers
    c, r = w["classes"], w["test_post_nms"]
    prob = L.softmax(cls)                                   # [R, C]
    deltas = L.transpose(L.reshape(box, [r, c, 4]), perm=[1, 0, 2])
    weights = L.assign(np.tile(np.float32(FRCNN_REG_WEIGHTS), (r, 1)))
    decoded = L.box_coder(rois, weights, deltas,
                          code_type="decode_center_size",
                          box_normalized=False)             # [C, R, 4]
    clipped = L.box_clip(L.reshape(decoded, [c * r, 4]), im_info)
    own = np.eye(c, dtype=np.float32)[:, :, None]
    own[0, 0] = 0.0                                        # no background
    tiled = L.expand(L.reshape(L.transpose(prob, perm=[1, 0]), [c, 1, r]),
                     [1, c, 1])                             # [C, C, R]
    scores = L.reshape(L.elementwise_mul(tiled, L.assign(own)),
                       [1, c, c * r])
    return L.multiclass_nms(L.reshape(clipped, [1, c * r, 4]), scores,
                            score_threshold=0.05, nms_top_k=r,
                            keep_top_k=100, nms_threshold=0.5,
                            normalized=False)


def frcnn_batch(seed, **widths):
    """An image uniform in [0, 1) and `gt` boxes, sides of 32 to 400
    pixels (scaled to the image), classes uniform over 1-80, none
    crowded."""
    w = dict(FRCNN, **widths)
    rng = np.random.RandomState(seed)
    h, wd = w["image"][1], w["image"][2]
    g = w["gt"]
    scale = min(h, wd) / 800.0
    size = rng.uniform(32, 400, (g, 2)) * scale
    lo = rng.uniform(0, 1, (g, 2)) * (np.array([wd, h]) - size - 1)
    boxes = np.concatenate([lo, lo + size], -1)
    return {"image": rng.rand(1, *w["image"]).astype(np.float32),
            "im_info": np.float32([[h, wd, 1.0]]),
            "gt_box": boxes.astype(np.float32),
            "gt_label": rng.randint(1, w["classes"], (g, 1)).astype(
                np.int32),
            "is_crowd": np.zeros((g, 1), np.int32)}


# ---- the chain --------------------------------------------------------------

YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
CHAIN = dict(pooled=7, yolo_batch=8, yolo_image=608, yolo_classes=80,
             yolo_gt=50, vgg=[2, 512, 37, 62], vgg_rois=128,
             rfcn=[1, 1029, 38, 63], rfcn_classes=21, rfcn_rois=128,
             face_map=32, face_image=1024, east=[8, 8, 128, 128],
             text=[1, 128, 128, 128], quads=64, text_out=[8, 64],
             cascade_rois=512, cascade_classes=81, fpn_rois=2000,
             mask_rois=512, mask_gt=16, mask_vertices=32, mask_classes=81,
             mask_res=14, p2=[200, 304])
CHAIN_NARROW = dict(pooled=3, yolo_batch=2, yolo_image=64, yolo_classes=3,
                    yolo_gt=4, vgg=[2, 4, 9, 12], vgg_rois=6,
                    rfcn=[1, 18, 9, 12],
                    rfcn_classes=2, rfcn_rois=5, face_map=4, face_image=128,
                    east=[2, 8, 6, 7], text=[1, 3, 12, 14], quads=3,
                    text_out=[4, 6], cascade_rois=6, cascade_classes=4,
                    fpn_rois=12, mask_rois=6, mask_gt=3, mask_vertices=5,
                    mask_classes=4, mask_res=5, p2=[5, 7])
CHAIN_LR = 1e-3
CHAIN_FEEDS = ["yolo_x0", "yolo_x1", "yolo_x2", "yolo_gt_box",
               "yolo_gt_label", "yolo_size", "vgg_x", "vgg_rois",
               "vgg_bid", "rfcn_x", "rfcn_rois", "face_x", "face_image",
               "east_x", "text_x", "quads", "cascade_prior", "cascade_var",
               "cascade_target", "cascade_score", "fpn_rois", "mask_rois",
               "mask_labels", "mask_gt_cls", "mask_segms", "mask_info",
               "mask_crowd", "p2_x"]


def _yolo_maps(w):
    """[(stride, side)] of YOLOv3's three heads, coarsest first."""
    return [(s, w["yolo_image"] // s) for s in (32, 16, 8)]


def _scaled(fluid, x, channels):
    """x times a per-channel parameter (starting at 1): the map's gradient
    reaches a parameter."""
    L = fluid.layers
    s = L.create_parameter([channels], "float32",
                           default_initializer=fluid.initializer.Constant(
                               1.0))
    return L.elementwise_mul(x, s, axis=1)


def detection_chain(fluid, seed=102, **widths):
    """The chain at `widths` (CHAIN's keys): main (SGD), startup seeded
    with `seed`, the loss; ``extra`` the outputs the chain's check reads."""
    w = dict(CHAIN, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers

    def data(name, shape, dtype="float32"):
        return L.data(name=name, shape=shape, dtype=dtype,
                      append_batch_size=False)
    ex = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        b, nc, ng = w["yolo_batch"], w["yolo_classes"], w["yolo_gt"]
        gt_box = data("yolo_gt_box", [b, ng, 4])
        gt_label = data("yolo_gt_label", [b, ng], "int32")
        size = data("yolo_size", [b, 2], "int32")
        terms, yolo = [], []
        for k, ((stride, side), mask) in enumerate(zip(_yolo_maps(w),
                                                       YOLO_MASKS)):
            c = 3 * (5 + nc)
            x = _scaled(fluid, data("yolo_x%d" % k, [b, c, side, side]), c)
            terms.append(L.reduce_mean(L.yolov3_loss(
                x, gt_box, gt_label, anchors=YOLO_ANCHORS, anchor_mask=mask,
                class_num=nc, ignore_thresh=0.7, downsample_ratio=stride)))
            anchors = sum(([YOLO_ANCHORS[2 * m], YOLO_ANCHORS[2 * m + 1]]
                           for m in mask), [])
            yolo.append(L.yolo_box(x, size, anchors=anchors, class_num=nc,
                                   conf_thresh=0.005,
                                   downsample_ratio=stride))
        ex["yolo_boxes"] = [bx for bx, _ in yolo]
        ex["yolo_scores"] = [sc for _, sc in yolo]
        vgg = L.relu(_scaled(fluid, data("vgg_x", w["vgg"]), w["vgg"][1]))
        ex["roi_pool"] = L.roi_pool(
            vgg, data("vgg_rois", [w["vgg_rois"], 4]), w["pooled"],
            w["pooled"], 1.0 / 16.0,
            batch_id=data("vgg_bid", [w["vgg_rois"]], "int64"))
        rfcn = _scaled(fluid, data("rfcn_x", w["rfcn"]), w["rfcn"][1])
        ex["psroi_pool"] = L.psroi_pool(
            rfcn, data("rfcn_rois", [w["rfcn_rois"], 4]), w["rfcn_classes"],
            1.0 / 16.0, w["pooled"], w["pooled"])
        text = _scaled(fluid, data("text_x", w["text"]), w["text"][1])
        th, tw = w["text_out"]
        ex["perspective"] = L.roi_perspective_transform(
            text, data("quads", [w["quads"], 8]), th, tw, 0.25)
        terms += [L.reduce_mean(ex[k]) for k in ("roi_pool", "psroi_pool",
                                                 "perspective")]
        loss = L.sums(terms)
        fm, fi = w["face_map"], w["face_image"]
        ex["density_boxes"], _ = L.density_prior_box(
            data("face_x", [1, 1, fm, fm]),
            data("face_image", [1, 1, fi, fi]), densities=[4, 2, 1],
            fixed_sizes=[32.0, 64.0, 128.0], fixed_ratios=[1.0], clip=True,
            flatten_to_2d=True)
        ex["polygons"] = L.polygon_box_transform(data("east_x", w["east"]))
        r, c = w["cascade_rois"], w["cascade_classes"]
        ex["decoded"], ex["assigned"] = L.box_decoder_and_assign(
            data("cascade_prior", [r, 4]), data("cascade_var", [4]),
            data("cascade_target", [r, 4 * c]),
            data("cascade_score", [r, c]), float(np.log(1000.0 / 16.0)))
        multi, restore = L.distribute_fpn_proposals(
            data("fpn_rois", [w["fpn_rois"], 4]), 2, 5, 4, 224)
        ex["fpn_levels"], ex["fpn_restore"] = multi, restore
        g = w["mask_gt"]
        ex["masks"] = L.generate_mask_labels(
            data("mask_info", [1, 3]), data("mask_gt_cls", [g], "int32"),
            data("mask_crowd", [g], "int32"),
            data("mask_segms", [g, w["mask_vertices"], 2]),
            data("mask_rois", [w["mask_rois"], 4]),
            data("mask_labels", [w["mask_rois"]], "int32"),
            w["mask_classes"], w["mask_res"])
        ex["p2_anchors"], _ = L.anchor_generator(
            data("p2_x", [1, 1] + w["p2"]), anchor_sizes=[32.0],
            aspect_ratios=[0.5, 1.0, 2.0], stride=[4.0, 4.0])
        fluid.optimizer.SGD(learning_rate=CHAIN_LR).minimize(loss)
    return Model(main, startup, loss, None, list(CHAIN_FEEDS), ex)


def _pixel_boxes(rng, n, h, w, lo=16.0, hi=None):
    """n corner boxes inside an h x w image, sides from lo to hi."""
    hi = hi or min(h, w) * 0.6
    size = rng.uniform(lo, max(hi, lo + 1), (n, 2))
    size = np.minimum(size, [w - 2, h - 2])
    corner = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - size - 1)
    return np.concatenate([corner, corner + size], -1).astype(np.float32)


def _polygons(rng, g, v, h, w):
    """g star-shaped polygons of v vertices inside an h x w image."""
    centre = rng.uniform(0.3, 0.7, (g, 1, 2)) * [w, h]
    ang = np.sort(rng.uniform(0, 2 * np.pi, (g, v)), axis=1)
    rad = rng.uniform(0.05, 0.2, (g, v, 1)) * min(h, w)
    return (centre + rad * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(
        np.float32)


def chain_batch(seed, **widths):
    """The chain's feeds: normal maps, gt and RoIs inside their images."""
    w = dict(CHAIN, **widths)
    rng = np.random.RandomState(seed)
    feed = {}
    b, nc, ng = w["yolo_batch"], w["yolo_classes"], w["yolo_gt"]
    for k, (_, side) in enumerate(_yolo_maps(w)):
        feed["yolo_x%d" % k] = (rng.randn(b, 3 * (5 + nc), side, side) *
                                0.5).astype(np.float32)
    boxes, real = _gt_boxes(rng, b, ng, ng, low=0.02)
    cxcywh = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2,
                             boxes[..., 2:] - boxes[..., :2]], -1)
    feed["yolo_gt_box"] = np.where(real[..., None], cxcywh, 0.0).astype(
        np.float32)
    feed["yolo_gt_label"] = np.where(real, rng.randint(0, nc, (b, ng)),
                                     0).astype(np.int32)
    feed["yolo_size"] = np.full((b, 2), w["yolo_image"], np.int32)
    n, c, h, wd = w["vgg"]
    feed["vgg_x"] = rng.randn(n, c, h, wd).astype(np.float32)
    feed["vgg_rois"] = _pixel_boxes(rng, w["vgg_rois"], h * 16, wd * 16)
    feed["vgg_bid"] = np.sort(rng.randint(0, n, w["vgg_rois"])).astype(
        np.int64)
    n, c, h, wd = w["rfcn"]
    feed["rfcn_x"] = rng.randn(n, c, h, wd).astype(np.float32)
    feed["rfcn_rois"] = _pixel_boxes(rng, w["rfcn_rois"], h * 16, wd * 16)
    feed["face_x"] = np.zeros((1, 1, w["face_map"], w["face_map"]),
                              np.float32)
    feed["face_image"] = np.zeros((1, 1, w["face_image"], w["face_image"]),
                                  np.float32)
    feed["east_x"] = (rng.randn(*w["east"]) * 8).astype(np.float32)
    n, c, h, wd = w["text"]
    feed["text_x"] = rng.randn(n, c, h, wd).astype(np.float32)
    quads = _pixel_boxes(rng, w["quads"], h * 4, wd * 4, lo=8.0)
    corners = np.stack([quads[:, [0, 1]], quads[:, [2, 1]],
                        quads[:, [2, 3]], quads[:, [0, 3]]], 1)
    corners = corners + rng.uniform(-3, 3, corners.shape)
    feed["quads"] = corners.reshape(-1, 8).astype(np.float32)
    r, c = w["cascade_rois"], w["cascade_classes"]
    feed["cascade_prior"] = _pixel_boxes(rng, r, 800, 1216)
    feed["cascade_var"] = np.float32([0.1, 0.1, 0.2, 0.2])
    feed["cascade_target"] = rng.randn(r, 4 * c).astype(np.float32)
    feed["cascade_score"] = rng.rand(r, c).astype(np.float32)
    feed["fpn_rois"] = _pixel_boxes(rng, w["fpn_rois"], 800, 1216, lo=4.0,
                                    hi=700.0)
    g, mr = w["mask_gt"], w["mask_rois"]
    feed["mask_rois"] = _pixel_boxes(rng, mr, 800, 1216)
    feed["mask_labels"] = np.where(rng.rand(mr) < 0.25,
                                   rng.randint(1, w["mask_classes"], mr),
                                   0).astype(np.int32)
    feed["mask_gt_cls"] = rng.randint(1, w["mask_classes"], g).astype(
        np.int32)
    feed["mask_segms"] = _polygons(rng, g, w["mask_vertices"], 800, 1216)
    feed["mask_info"] = np.float32([[800, 1216, 1.0]])
    feed["mask_crowd"] = np.zeros(g, np.int32)
    feed["p2_x"] = np.zeros([1, 1] + w["p2"], np.float32)
    return feed


PROGRAMS = {"mobilenet_ssd": (mobilenet_ssd, ssd_batch, SSD_NARROW),
            "faster_rcnn": (faster_rcnn, frcnn_batch, FRCNN_NARROW),
            "detection_chain": (detection_chain, chain_batch, CHAIN_NARROW)}
