"""The detection layers (``paddle_tpu_torch/fluid/layers/detection.py``'s
26), the ``detection_map`` host op and both DetectionMAPs on the port
against the JAX package's, on the CPU.

- ``fluid.layers`` exports the 26 names, and each layer builds the JAX
  package's program op for op (main and startup), the composite layers
  (``ssd_loss``, ``detection_output``, ``multi_box_head``) included.
- Each program of the layers run on both executors from the same state
  and feeds: float outputs within 1e-5 of the largest JAX magnitude,
  integer outputs exactly.
- The ``detection_map`` host op without state, and
  ``fluid.evaluator.DetectionMAP`` over three runs carrying its PosCount,
  TruePos and FalsePos state, then reset: every mAP and state equal to
  the JAX package's, 11point and integral. ``fluid.metrics.DetectionMAP``
  fed the same arrays (and tensors) three times: every eval equal.
- One test for each difference from the Paddle reference that both
  packages share (ROADMAP Queue 3): multiclass_nms reads no
  background_label; roi_align with sampling_ratio <= 0 samples
  ceil(H / ph) rows a bin whatever the RoI; rpn_target_assign takes the
  hardest anchors, not a random pick; generate_mask_labels takes padded
  polygons [G, P, 2]; box_coder reads no axis; multiclass_nms reads no
  normalized; detection_output applies no softmax.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

TOL = 1e-5
B, G, P = 2, 3, 12


def _rng(seed):
    return np.random.RandomState(seed)


def _boxes(n, seed, size=1.0, lead=()):
    r = _rng(seed)
    lo = r.rand(*lead, n, 2) * size * 0.7
    wh = (r.rand(*lead, n, 2) * 0.5 + 0.05) * size
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _data(fluid, name, shape, dtype="float32"):
    return fluid.layers.data(name=name, shape=shape, dtype=dtype,
                             append_batch_size=False)


# ---------------------------------------------------------------- builders
# name -> fn(fluid) -> (fetch list, feed dict); each builds its layer (and
# what feeds it) in the current program

def _prior_box(fluid):
    L = fluid.layers
    feat = _data(fluid, "feat", [B, 4, 5, 6])
    image = _data(fluid, "image", [B, 3, 30, 36])
    boxes, var = L.prior_box(feat, image, min_sizes=[4.0], max_sizes=[9.0],
                             aspect_ratios=[2.0], flip=True, clip=True)
    return [boxes, var], {"feat": np.zeros((B, 4, 5, 6), np.float32),
                          "image": np.zeros((B, 3, 30, 36), np.float32)}


def _density_prior_box(fluid):
    L = fluid.layers
    feat = _data(fluid, "feat", [1, 4, 4, 5])
    image = _data(fluid, "image", [1, 3, 32, 40])
    boxes, var = L.density_prior_box(feat, image, densities=[2, 1],
                                     fixed_sizes=[8.0, 16.0],
                                     fixed_ratios=[1.0], clip=True,
                                     flatten_to_2d=True)
    return [boxes, var], {"feat": np.zeros((1, 4, 4, 5), np.float32),
                          "image": np.zeros((1, 3, 32, 40), np.float32)}


def _anchor_generator(fluid):
    feat = _data(fluid, "feat", [1, 4, 3, 4])
    anchors, var = fluid.layers.anchor_generator(
        feat, anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0],
        stride=[16.0, 16.0])
    return [anchors, var], {"feat": np.zeros((1, 4, 3, 4), np.float32)}


def _box_coder(fluid):
    L = fluid.layers
    prior = _data(fluid, "prior", [P, 4])
    pvar = _data(fluid, "pvar", [P, 4])
    gt = _data(fluid, "gt", [B, G, 4])
    loc = _data(fluid, "loc", [B, P, 4])
    enc = L.box_coder(prior, pvar, gt)
    dec = L.box_coder(prior, pvar, loc, code_type="decode_center_size")
    r = _rng(1)
    return [enc, dec], {"prior": _boxes(P, 2), "pvar": np.tile(np.float32(
        [0.1, 0.1, 0.2, 0.2]), (P, 1)), "gt": _boxes(G, 3, lead=(B,)),
        "loc": (r.randn(B, P, 4) * 0.5).astype(np.float32)}


def _iou_similarity(fluid):
    x = _data(fluid, "x", [B, G, 4])
    y = _data(fluid, "y", [P, 4])
    return [fluid.layers.iou_similarity(x, y)], {
        "x": _boxes(G, 4, lead=(B,)), "y": _boxes(P, 5)}


def _yolo_box(fluid):
    x = _data(fluid, "x", [B, 3 * 9, 4, 5])
    size = _data(fluid, "size", [B, 2], "int32")
    boxes, scores = fluid.layers.yolo_box(
        x, size, anchors=[10, 13, 16, 30, 33, 23], class_num=4,
        conf_thresh=0.3, downsample_ratio=32)
    return [boxes, scores], {
        "x": _rng(6).randn(B, 27, 4, 5).astype(np.float32),
        "size": np.array([[128, 160], [120, 150]], np.int32)}


def _multiclass_nms(fluid):
    bboxes = _data(fluid, "bboxes", [B, P, 4])
    scores = _data(fluid, "scores", [B, 3, P])
    out = fluid.layers.multiclass_nms(bboxes, scores, score_threshold=0.1,
                                      nms_top_k=6, keep_top_k=10,
                                      nms_threshold=0.4)
    return [out], {"bboxes": _boxes(P, 7, lead=(B,)),
                   "scores": _rng(8).rand(B, 3, P).astype(np.float32)}


def _detection_output(fluid):
    L = fluid.layers
    loc = _data(fluid, "loc", [B, P, 4])
    conf = _data(fluid, "conf", [B, P, 3])
    prior = _data(fluid, "prior", [P, 4])
    pvar = _data(fluid, "pvar", [P, 4])
    scores = L.transpose(L.softmax(conf), perm=[0, 2, 1])
    out = L.detection_output(loc, scores, prior, pvar, nms_threshold=0.45,
                             nms_top_k=8, keep_top_k=10)
    r = _rng(9)
    return [out], {"loc": (r.randn(B, P, 4) * 0.3).astype(np.float32),
                   "conf": r.randn(B, P, 3).astype(np.float32),
                   "prior": _boxes(P, 10), "pvar": np.tile(np.float32(
                       [0.1, 0.1, 0.2, 0.2]), (P, 1))}


def _ssd_feeds(seed):
    r = _rng(seed)
    gt = _boxes(G, seed, lead=(B,))
    label = r.randint(1, 3, (B, G, 1)).astype(np.int32)
    gt[1, 2] = 0.0                                # a padded gt row
    label[1, 2] = -1
    return {"loc": (r.randn(B, P, 4) * 0.3).astype(np.float32),
            "conf": r.randn(B, P, 3).astype(np.float32), "gt": gt,
            "label": label, "prior": _boxes(P, seed + 1),
            "pvar": np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (P, 1))}


def _ssd_loss(fluid):
    L = fluid.layers
    loc = _data(fluid, "loc", [B, P, 4])
    conf = _data(fluid, "conf", [B, P, 3])
    gt = _data(fluid, "gt", [B, G, 4])
    label = _data(fluid, "label", [B, G, 1], "int32")
    prior = _data(fluid, "prior", [P, 4])
    pvar = _data(fluid, "pvar", [P, 4])
    loss = L.ssd_loss(loc, conf, gt, label, prior, pvar)
    return [loss], _ssd_feeds(11)


def _multi_box_head(fluid):
    L = fluid.layers
    image = _data(fluid, "image", [B, 3, 32, 32])
    f1 = L.conv2d(image, num_filters=4, filter_size=3, stride=4, padding=1)
    f2 = L.conv2d(f1, num_filters=4, filter_size=3, stride=2, padding=1)
    f3 = L.conv2d(f2, num_filters=4, filter_size=3, stride=2, padding=1)
    locs, confs, boxes, var = L.multi_box_head(
        inputs=[f1, f2, f3], image=image, base_size=32, num_classes=3,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], min_ratio=20,
        max_ratio=90, offset=0.5, flip=True)
    return [locs, confs, boxes, var], {
        "image": _rng(12).rand(B, 3, 32, 32).astype(np.float32)}


def _bipartite_match(fluid):
    dist = _data(fluid, "dist", [B, G, P])
    idx, d = fluid.layers.bipartite_match(dist, "per_prediction", 0.3)
    return [idx, d], {"dist": (np.round(_rng(13).rand(B, G, P) * 4) / 4)
                      .astype(np.float32)}


def _target_assign(fluid):
    x = _data(fluid, "x", [B, G, 4])
    match = _data(fluid, "match", [B, P], "int32")
    neg = _data(fluid, "neg", [B, P], "int32")
    out, w = fluid.layers.target_assign(x, match, negative_indices=neg,
                                        mismatch_value=0)
    negs = np.full((B, P), -1, np.int32)
    negs[:, :2] = [[1, 5], [0, 3]]
    return [out, w], {"x": _boxes(G, 14, lead=(B,)),
                      "match": _rng(14).randint(-1, G, (B, P)).astype(
                          np.int32), "neg": negs}


def _box_clip(fluid):
    boxes = _data(fluid, "boxes", [B, P, 4])
    info = _data(fluid, "info", [B, 3])
    return [fluid.layers.box_clip(boxes, info)], {
        "boxes": (_rng(15).randn(B, P, 4) * 20).astype(np.float32),
        "info": np.float32([[20, 30, 1], [25, 18, 1]])}


def _polygon_box_transform(fluid):
    x = _data(fluid, "x", [B, 8, 4, 5])
    return [fluid.layers.polygon_box_transform(x)], {
        "x": _rng(16).randn(B, 8, 4, 5).astype(np.float32)}


def _roi_in(fluid, channels=3):
    x = _data(fluid, "x", [B, channels, 10, 12])
    rois = _data(fluid, "rois", [5, 4])
    bid = _data(fluid, "bid", [5], "int64")
    return x, rois, bid, {
        "x": _rng(17).randn(B, channels, 10, 12).astype(np.float32),
        "rois": _boxes(5, 18, 20.0),
        "bid": np.array([0, 1, 1, 0, 1], np.int64)}


def _roi_pool(fluid):
    x, rois, bid, feed = _roi_in(fluid)
    return [fluid.layers.roi_pool(x, rois, 2, 3, 0.5, batch_id=bid)], feed


def _roi_align(fluid):
    x, rois, bid, feed = _roi_in(fluid)
    return [fluid.layers.roi_align(x, rois, 2, 3, 0.5, 2,
                                   batch_id=bid)], feed


def _psroi_pool(fluid):
    x, rois, bid, feed = _roi_in(fluid, 8)
    return [fluid.layers.psroi_pool(x, rois, 2, 0.5, 2, 2,
                                    batch_id=bid)], feed


def _roi_perspective_transform(fluid):
    x = _data(fluid, "x", [1, 3, 10, 12])
    rois = _data(fluid, "rois", [3, 8])
    quads = np.float32([[1, 1, 9, 2, 10, 8, 2, 7], [4, 3, 14, 3, 15, 12,
                                                    3, 13],
                        [0, 0, 6, 0, 6, 5, 0, 5]])
    return [fluid.layers.roi_perspective_transform(x, rois, 4, 5, 0.5)], {
        "x": _rng(19).randn(1, 3, 10, 12).astype(np.float32),
        "rois": quads}


def _proposal_feeds(seed, h=4, w=5, a=2):
    r = _rng(seed)
    return {"scores": r.randn(1, a, h, w).astype(np.float32),
            "deltas": (r.randn(1, 4 * a, h, w) * 0.3).astype(np.float32),
            "info": np.float32([[64, 80, 1.0]]),
            "gt": _boxes(G, seed + 1, 60.0),
            "gt_cls": np.array([[1], [2], [1]], np.int32),
            "crowd": np.array([[0], [0], [1]], np.int32)}


def _generate_proposals(fluid):
    L = fluid.layers
    scores = _data(fluid, "scores", [1, 2, 4, 5])
    deltas = _data(fluid, "deltas", [1, 8, 4, 5])
    info = _data(fluid, "info", [1, 3])
    anchors, var = L.anchor_generator(scores, anchor_sizes=[16.0, 32.0],
                                      aspect_ratios=[1.0],
                                      stride=[16.0, 16.0])
    rois, probs = L.generate_proposals(scores, deltas, info, anchors, var,
                                       pre_nms_top_n=30, post_nms_top_n=12,
                                       nms_thresh=0.6, min_size=1.0)
    feed = _proposal_feeds(20)
    return [rois, probs], {k: feed[k] for k in ("scores", "deltas", "info")}


def _rpn_target_assign(fluid):
    L = fluid.layers
    scores = _data(fluid, "scores", [1, 2, 4, 5])
    info = _data(fluid, "info", [1, 3])
    gt = _data(fluid, "gt", [G, 4])
    crowd = _data(fluid, "crowd", [G, 1], "int32")
    anchors, var = L.anchor_generator(scores, anchor_sizes=[16.0, 32.0],
                                      aspect_ratios=[1.0],
                                      stride=[16.0, 16.0])
    anchors = L.reshape(anchors, [-1, 4])
    outs = L.rpn_target_assign(None, None, anchors, var, gt, crowd, info,
                               rpn_batch_size_per_im=16,
                               rpn_positive_overlap=0.5)
    feed = _proposal_feeds(21)
    return list(outs), {k: feed[k] for k in ("scores", "info", "gt",
                                             "crowd")}


def _distribute_fpn_proposals(fluid):
    rois = _data(fluid, "rois", [10, 4])
    multi, restore = fluid.layers.distribute_fpn_proposals(rois, 2, 5, 4,
                                                           224)
    return multi + [restore], {"rois": _boxes(10, 22, 900.0)}


def _yolov3_loss(fluid):
    x = _data(fluid, "x", [B, 3 * 9, 4, 4])
    gtbox = _data(fluid, "gtbox", [B, G, 4])
    gtlabel = _data(fluid, "gtlabel", [B, G], "int32")
    loss = fluid.layers.yolov3_loss(
        x, gtbox, gtlabel, anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                                    59, 119], anchor_mask=[0, 1, 2],
        class_num=4, ignore_thresh=0.5, downsample_ratio=8)
    r = _rng(23)
    gt = np.concatenate([r.rand(B, G, 2) * 0.8 + 0.1,
                         r.rand(B, G, 2) * 0.3 + 0.05], -1)
    return [loss], {"x": (r.randn(B, 27, 4, 4) * 0.5).astype(np.float32),
                    "gtbox": gt.astype(np.float32),
                    "gtlabel": r.randint(0, 4, (B, G)).astype(np.int32)}


def _box_decoder_and_assign(fluid):
    prior = _data(fluid, "prior", [5, 4])
    pvar = _data(fluid, "pvar", [4])
    target = _data(fluid, "target", [5, 12])
    score = _data(fluid, "score", [5, 3])
    dec, assigned = fluid.layers.box_decoder_and_assign(prior, pvar, target,
                                                        score, 4.135)
    r = _rng(24)
    return [dec, assigned], {"prior": _boxes(5, 24, 40.0),
                             "pvar": np.float32([0.1, 0.1, 0.2, 0.2]),
                             "target": r.randn(5, 12).astype(np.float32),
                             "score": r.rand(5, 3).astype(np.float32)}


def _label_inputs(fluid):
    rois = _data(fluid, "rois", [16, 4])
    gt_cls = _data(fluid, "gt_cls", [G, 1], "int32")
    crowd = _data(fluid, "crowd", [G, 1], "int32")
    gt = _data(fluid, "gt", [G, 4])
    info = _data(fluid, "info", [1, 3])
    feed = _proposal_feeds(25)
    feed["rois"] = np.concatenate([_boxes(13, 26, 60.0), feed["gt"]])
    return rois, gt_cls, crowd, gt, info, {
        k: feed[k] for k in ("rois", "gt_cls", "crowd", "gt", "info")}


def _generate_proposal_labels(fluid):
    rois, gt_cls, crowd, gt, info, feed = _label_inputs(fluid)
    outs = fluid.layers.generate_proposal_labels(
        rois, gt_cls, crowd, gt, info, batch_size_per_im=12,
        fg_fraction=0.25, fg_thresh=0.5, class_nums=3, use_random=False)
    return list(outs), feed


def _generate_mask_labels(fluid):
    rois, gt_cls, crowd, gt, info, feed = _label_inputs(fluid)
    segms = _data(fluid, "segms", [G, 4, 2])
    labels = _data(fluid, "labels", [16], "int32")
    outs = fluid.layers.generate_mask_labels(info, gt_cls, crowd, segms,
                                             rois, labels, 3, 5)
    g = feed["gt"]
    feed["segms"] = np.stack([g[:, [0, 1]], g[:, [2, 1]], g[:, [2, 3]],
                              g[:, [0, 3]]], 1).astype(np.float32)
    feed["labels"] = _rng(27).randint(-1, 3, 16).astype(np.int32)
    return list(outs), feed


def _detection_map(fluid):
    det = _data(fluid, "det", [B, 6, 6])
    label = _data(fluid, "label", [B, G, 6])
    m = fluid.layers.detection_map(det, label, 3, overlap_threshold=0.5,
                                   ap_version="11point")
    return [m], _map_feeds(28)


BUILDERS = {
    "prior_box": _prior_box, "density_prior_box": _density_prior_box,
    "anchor_generator": _anchor_generator, "box_coder": _box_coder,
    "iou_similarity": _iou_similarity, "yolo_box": _yolo_box,
    "multiclass_nms": _multiclass_nms, "detection_output": _detection_output,
    "ssd_loss": _ssd_loss, "multi_box_head": _multi_box_head,
    "bipartite_match": _bipartite_match, "target_assign": _target_assign,
    "box_clip": _box_clip, "polygon_box_transform": _polygon_box_transform,
    "roi_pool": _roi_pool, "roi_align": _roi_align,
    "psroi_pool": _psroi_pool,
    "roi_perspective_transform": _roi_perspective_transform,
    "generate_proposals": _generate_proposals,
    "rpn_target_assign": _rpn_target_assign,
    "distribute_fpn_proposals": _distribute_fpn_proposals,
    "yolov3_loss": _yolov3_loss,
    "box_decoder_and_assign": _box_decoder_and_assign,
    "generate_proposal_labels": _generate_proposal_labels,
    "generate_mask_labels": _generate_mask_labels,
    "detection_map": _detection_map,
}


def _program(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch, feed = BUILDERS[name](fluid)
    return main, startup, fetch, feed


def _check(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    bound = TOL * (np.abs(want).max() or 1.0)
    assert np.abs(got - want).max() <= bound, (
        err_msg, np.abs(got - want).max(), bound)


def _run_both(name):
    """The layer's program run once on each executor from the port's
    startup state: (JAX values, port values)."""
    jmain, _, jfetch, feed = _program(jfluid, name)
    tmain, tstartup, tfetch, _ = _program(tfluid, name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstartup, scope=tscope)
    jscope = jfluid.Scope()
    for v in tmain.global_block().vars.values():
        if v.persistable and tscope.get(v.name) is not None:
            jscope.set(v.name, tfluid.executor.as_numpy(tscope.get(v.name)))
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=jfetch, scope=jscope)
    got = texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope)
    return want, got


def test_fluid_layers_export_the_26_names():
    names = set(jfluid.layers.detection.__all__)
    assert len(names) == 26
    assert set(tfluid.layers.detection.__all__) == names == set(BUILDERS)
    for n in names:
        assert getattr(tfluid.layers, n) is getattr(tfluid.layers.detection,
                                                    n), n


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_builds_the_jax_program(name):
    j, t = _program(jfluid, name), _program(tfluid, name)
    assert step.signature(t[0]) == step.signature(j[0])
    assert step.signature(t[1]) == step.signature(j[1])


# the layers whose programs the lowering tests do not already run op by
# op: the composites, and the host op
RUN = ["ssd_loss", "detection_output", "multi_box_head", "detection_map"]


@pytest.mark.parametrize("name", RUN)
def test_layer_program_runs_as_the_jax_one(name):
    want, got = _run_both(name)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        _check(g, w, "%s[%d]" % (name, k))


# ----------------------------------------------------------------- mAP

def _map_feeds(seed, batch=B, k=6):
    """Detections [B, k, 6] near the ground truth [B, G, 6] (a difficult
    box, a padded row, a missed box and false alarms among them)."""
    r = _rng(seed)
    gt = np.zeros((batch, G, 6), np.float32)
    gt[..., 0] = r.randint(1, 3, (batch, G))
    gt[..., 1:5] = _boxes(G, seed, lead=(batch,))
    gt[0, 1, 5] = 1.0                                  # difficult
    gt[-1, -1, 0] = -1                                 # padding
    det = np.zeros((batch, k, 6), np.float32)
    det[..., 0] = r.randint(1, 3, (batch, k))
    det[..., 1] = np.round(r.rand(batch, k) * 10) / 10   # tied scores
    src = gt[:, r.randint(0, G, k), 1:5]
    det[..., 2:6] = src + r.randn(batch, k, 4).astype(np.float32) * 0.03
    det[:, :G - 1, 0] = gt[:, :G - 1, 0]               # hits
    det[-1, -1, 0] = -1                                # padding
    return {"det": det, "label": gt}


def _evaluator_program(fluid, ap_version):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        det = _data(fluid, "det", [B, 6, 6])
        gt_label = _data(fluid, "gt_label", [B, G, 1], "int32")
        gt_box = _data(fluid, "gt_box", [B, G, 4])
        difficult = _data(fluid, "difficult", [B, G, 1], "int32")
        ev = fluid.evaluator.DetectionMAP(
            det, gt_label, gt_box, difficult, class_num=3,
            overlap_threshold=0.5, evaluate_difficult=False,
            ap_version=ap_version)
    return main, startup, ev


def _evaluator_feed(seed):
    f = _map_feeds(seed)
    g = f["label"]
    return {"det": f["det"], "gt_label": g[..., :1].astype(np.int32),
            "gt_box": g[..., 1:5], "difficult": g[..., 5:].astype(np.int32)}


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
def test_detection_map_evaluator_carries_state_as_the_jax_one(ap_version):
    """Three runs, a reset and one more: both mAPs and the three states
    after each run equal the JAX evaluator's."""
    jm, js, jev = _evaluator_program(jfluid, ap_version)
    tm, ts, tev = _evaluator_program(tfluid, ap_version)
    assert step.signature(tm) == step.signature(jm)
    assert step.signature(ts) == step.signature(js)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    accum = []
    for k in range(4):
        if k == 3:
            with jfluid.scope_guard(jscope):
                jev.reset(jexe)
            with tfluid.scope_guard(tscope):
                tev.reset(texe)
        feed = _evaluator_feed(40 + k)
        want = jexe.run(jm, feed=feed, fetch_list=jev.metrics, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=tev.metrics, scope=tscope)
        for g, w in zip(got, want):
            _check(g, w, "run %d" % k)
        for jv, tv in zip(jev.states, tev.states):
            _check(tfluid.executor.as_numpy(tscope.get(tv.name)),
                   np.asarray(jscope.get(jv.name)), tv.name)
        accum.append(float(got[1][0]))
    assert accum[3] != accum[2]        # the reset dropped the carried state


def test_metrics_detection_map_matches_the_jax_one():
    for ap_version in ("11point", "integral"):
        jm = jfluid.metrics.DetectionMAP(ap_version=ap_version,
                                         evaluate_difficult=False)
        tm = tfluid.metrics.DetectionMAP(ap_version=ap_version,
                                         evaluate_difficult=False)
        for k in range(3):
            f = _map_feeds(50 + k)
            jm.update(f["det"], f["label"])
            tm.update(torch.from_numpy(f["det"]) if k % 2 else f["det"],
                      f["label"])
            assert tm.eval() == jm.eval()
        tm.reset()
        assert tm.eval() == 0.0
    with pytest.raises(ValueError):
        tfluid.metrics.DetectionMAP(ap_version="voc")


# ------------------------------------------------------ Queue 3 differences

def _lower_both(op, arrays, attrs):
    from paddle_tpu.fluid.ops import registry as jreg
    from paddle_tpu_torch.fluid.ops import registry as treg
    import jax.numpy as jnp
    want = jreg.get_lowering(op)(jreg.LoweringContext(), {
        k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), {
        k: [torch.from_numpy(a) for a in v] for k, v in arrays.items()},
        attrs)
    return ({k: [np.asarray(a) for a in v] for k, v in want.items()},
            {k: [a.numpy() for a in v] for k, v in got.items()})


def test_multiclass_nms_reads_no_background_label_in_both_packages():
    """The reference skips the background class; both packages keep it:
    class 0's boxes come out, whatever background_label says."""
    arrays = {"BBoxes": [_boxes(P, 60, lead=(1,))],
              "Scores": [np.full((1, 2, P), 0.01, np.float32)]}
    arrays["Scores"][0][0, 0, :3] = 0.9        # class 0 the best
    outs = []
    for bg in (0, 1, -1):
        attrs = {"score_threshold": 0.05, "nms_top_k": P, "keep_top_k": 4,
                 "nms_threshold": 0.99, "background_label": bg}
        want, got = _lower_both("multiclass_nms", arrays, attrs)
        np.testing.assert_array_equal(got["Out"][0], want["Out"][0])
        outs.append(got["Out"][0])
    assert (outs[0][0, :3, 0] == 0).all()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_roi_align_samples_by_the_map_size_in_both_packages():
    """sampling_ratio <= 0 samples ceil(H / ph) x ceil(W / pw) points a bin
    for every RoI (the reference: ceil(roi_h / ph) x ceil(roi_w / pw)): a
    small RoI gives what sampling_ratio ceil(H / ph) gives, not what the
    reference's count for it gives."""
    x = _rng(61).randn(1, 2, 12, 12).astype(np.float32)
    rois = np.float32([[2.0, 3.0, 5.0, 5.5]])          # 3 x 2.5 cells
    base = {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}
    res = {}
    for sr in (-1, 6, 2):                   # ceil(12 / 2) = 6
        want, got = _lower_both("roi_align", {"X": [x], "ROIs": [rois]},
                                dict(base, sampling_ratio=sr))
        np.testing.assert_allclose(got["Out"][0], want["Out"][0],
                                   rtol=1e-5, atol=1e-6)
        res[sr] = got["Out"][0]
    np.testing.assert_allclose(res[-1], res[6], rtol=1e-6)
    assert np.abs(res[-1] - res[2]).max() > 1e-3   # reference's ceil(3/2)


def test_rpn_target_assign_takes_the_hardest_anchors_in_both_packages():
    """The reference samples fg and bg anchors at random; both packages
    take the fg anchors of highest IoU first and the bg anchors of lowest
    IoU first, the same ones on every call."""
    anc = np.concatenate([_boxes(40, 62, 60.0), _boxes(4, 63, 60.0)])
    gt = _boxes(2, 64, 60.0)
    arrays = {"Anchor": [anc], "GtBoxes": [gt],
              "IsCrowd": [np.zeros(2, np.int32)],
              "ImInfo": [np.float32([[64, 64, 1.0]])]}
    attrs = {"rpn_batch_size_per_im": 8, "rpn_fg_fraction": 0.5,
             "rpn_positive_overlap": 0.3, "rpn_negative_overlap": 0.2,
             "rpn_straddle_thresh": -1.0}
    want, got = _lower_both("rpn_target_assign", arrays, attrs)
    for slot in ("LocationIndex", "ScoreIndex", "TargetLabel"):
        np.testing.assert_array_equal(got[slot][0], want[slot][0])
    import paddle_tpu_torch.fluid.ops.detection_ops as D
    iou = D.iou_matrix(torch.from_numpy(gt), torch.from_numpy(anc),
                       normalized=False).amax(0).numpy()
    fg = got["LocationIndex"][0]
    fg = fg[fg >= 0]
    assert (np.diff(iou[fg]) <= 0).all()                 # hardest first
    bg = got["ScoreIndex"][0][4:]
    bg = bg[bg >= 0]
    assert (np.diff(iou[bg]) >= 0).all()                 # lowest IoU first
    again = _lower_both("rpn_target_assign", arrays, attrs)[1]
    np.testing.assert_array_equal(again["ScoreIndex"][0],
                                  got["ScoreIndex"][0])


def test_generate_mask_labels_takes_padded_polygons_in_both_packages():
    """GtSegms is a dense [G, P, 2] polygon tensor (the reference: COCO
    LoD polygon lists); a polygon padded by repeating its last vertex
    rasterizes as the unpadded one."""
    square = np.float32([[2, 2], [12, 2], [12, 12], [2, 12]])
    padded = np.concatenate([square, square[-1:], square[-1:]])
    tri = np.float32([[20, 20], [30, 20], [25, 28], [25, 28], [25, 28],
                      [25, 28]])
    base = {"Rois": [np.float32([[0, 0, 14, 14], [18, 18, 32, 30]])],
            "LabelsInt32": [np.int32([1, 2])],
            "GtClasses": [np.int32([1, 2])]}
    attrs = {"num_classes": 3, "resolution": 7}
    want, got = _lower_both("generate_mask_labels",
                            dict(base, GtSegms=[np.stack([padded, tri])]),
                            attrs)
    np.testing.assert_array_equal(got["MaskInt32"][0], want["MaskInt32"][0])
    _, plain = _lower_both("generate_mask_labels",
                           dict(base, GtSegms=[np.stack([square,
                                                         tri[:4]])]), attrs)
    mask = got["MaskInt32"][0][0].reshape(3, 7, 7)
    np.testing.assert_array_equal(mask[1], plain["MaskInt32"][0][0]
                                  .reshape(3, 7, 7)[1])
    assert mask[1].sum() > 0 and (mask[0] == -1).all()


def test_box_coder_reads_no_axis_in_both_packages():
    """The reference's axis=1 pairs PriorBox with TargetBox's first axis;
    both packages read no axis: decoding [N, M, 4] targets over [M, 4]
    priors gives the same at axis 0 and 1."""
    prior = _boxes(4, 65)
    target = (_rng(66).randn(3, 4, 4) * 0.3).astype(np.float32)
    outs = []
    for axis in (0, 1):
        attrs = {"code_type": "decode_center_size", "axis": axis}
        want, got = _lower_both("box_coder", {"PriorBox": [prior],
                                              "TargetBox": [target]}, attrs)
        np.testing.assert_allclose(got["OutputBox"][0],
                                   want["OutputBox"][0], rtol=1e-6,
                                   atol=1e-7)
        outs.append(got["OutputBox"][0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_multiclass_nms_reads_no_normalized_in_both_packages():
    """The reference measures pixel boxes (normalized=False) with + 1 in
    each side; both packages measure every box as normalized: two boxes
    whose IoU is 0.5 without the + 1 and 0.55 with it both survive an NMS
    at 0.52 whatever normalized says."""
    boxes = np.float32([[[0, 0, 9, 9], [0, 0, 9, 4.5]]])   # IoU 0.5
    scores = np.float32([[[0.9, 0.8]]])
    outs = []
    for normalized in (True, False):
        attrs = {"score_threshold": 0.1, "nms_top_k": 2, "keep_top_k": 2,
                 "nms_threshold": 0.52, "normalized": normalized}
        want, got = _lower_both("multiclass_nms", {"BBoxes": [boxes],
                                                   "Scores": [scores]},
                                attrs)
        np.testing.assert_array_equal(got["Out"][0], want["Out"][0])
        outs.append(got["Out"][0])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[1][0, :, 0] == 0).all()                 # both kept


def test_detection_output_applies_no_softmax_in_both_packages():
    """The reference's detection_output takes [N, M, C] confidences and
    applies softmax and a transpose itself; both packages' take the [N,
    C, M] scores as they are: a score of 5 comes out 5."""
    outs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loc = _data(fluid, "loc", [1, 4, 4])
            scores = _data(fluid, "scores", [1, 2, 4])
            prior = _data(fluid, "prior", [4, 4])
            pvar = _data(fluid, "pvar", [4, 4])
            out = fluid.layers.detection_output(loc, scores, prior, pvar,
                                                nms_top_k=4, keep_top_k=4)
        feed = {"loc": np.zeros((1, 4, 4), np.float32),
                "scores": np.float32([[[5, 0, 0, 0], [0, 0, 3, 0]]]),
                "prior": np.float32([[0, 0, .2, .2], [.5, .5, .9, .9],
                                     [.1, .6, .3, .9], [.6, 0, .9, .3]]),
                "pvar": np.full((4, 4), 0.1, np.float32)}
        exe = fluid.Executor(fluid.CPUPlace())
        outs.append(np.asarray(exe.run(main, feed=feed,
                                       fetch_list=[out])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)
    assert outs[1][0, 0, 1] == 5.0 and outs[1][0, 1, 1] == 3.0
