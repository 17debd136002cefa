"""The detection lowerings (``paddle_tpu_torch/fluid/ops/detection_ops.py``'s
23) against the JAX package's on the same seeded numpy inputs, on the CPU.

- Forwards: every output of every case. Float outputs within 1e-5 of the
  largest JAX magnitude; integer outputs (match indices, NMS labels held
  in float32, argmaxes, kept rows, RoI counts, assigned labels, masks)
  exactly, with their dtypes.
- Gradients (roi_pool, roi_align, psroi_pool, yolov3_loss,
  roi_perspective_transform): ``jax.vjp`` of the JAX lowering against
  autograd through the port's, a seeded cotangent on the float output,
  within 1e-4 of the largest JAX gradient.
- Ties in every ranking op (multiclass_nms's zero-score padding and tied
  scores, mine_hard_examples' tied losses, generate_proposals' tied
  scores, rpn_target_assign's and generate_proposal_labels' tied IoUs from
  repeated boxes, distribute_fpn_proposals' levels): the lower index
  first, as ``jax.lax.top_k`` and the stable ``jnp.argsort`` put it; and
  ``top_k`` itself against ``jax.lax.top_k`` on tied vectors.
- roi_pool over quantized maps (tied maxima in its bins, the gradient
  split among them) and RoIs partly and wholly off the map (empty bins:
  Out 0, Argmax -1).
- The live ``box_decoder_and_assign`` (the JAX module's second
  definition): no clip at box_clip 0, a [4] and an [R, 4] variance, the
  best non-background class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.fluid  # noqa: F401
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import common, detection_ops
from paddle_tpu_torch.fluid.ops import registry as treg

TOL = 1e-5
GRAD_TOL = 1e-4
DETECTION_OPS = {
    "prior_box", "box_coder", "iou_similarity", "yolo_box", "multiclass_nms",
    "roi_pool", "roi_align", "psroi_pool", "anchor_generator",
    "density_prior_box", "bipartite_match", "target_assign", "box_clip",
    "polygon_box_transform", "mine_hard_examples", "generate_proposals",
    "rpn_target_assign", "distribute_fpn_proposals", "yolov3_loss",
    "roi_perspective_transform", "generate_proposal_labels",
    "generate_mask_labels", "box_decoder_and_assign"}
# the output slots the JAX lowerings make int64 (int32 with x64 off)
INT64 = {"Argmax"}
# float input -> output slot whose gradient is taken
GRAD_SLOTS = {"roi_pool": ("X", "Out"), "roi_align": ("X", "Out"),
              "psroi_pool": ("X", "Out"), "yolov3_loss": ("X", "Loss"),
              "roi_perspective_transform": ("X", "Out")}


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _ties(*shape, seed=0):
    """ReLU'd normals rounded to halves: many bins hold tied maxima."""
    return np.maximum(np.round(_randn(*shape, seed=seed) * 2) / 2,
                      0).astype(np.float32)


def _boxes(n, seed, size=1.0, lead=()):
    """n valid boxes (x1 < x2, y1 < y2) inside [0, size]."""
    r = _rng(seed)
    lo = r.rand(*lead, n, 2) * size * 0.7
    wh = (r.rand(*lead, n, 2) * 0.5 + 0.05) * size
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _prior_in(**attrs):
    a = dict(min_sizes=[4.0, 8.0], max_sizes=[9.0, 15.0],
             aspect_ratios=[2.0, 3.0], variances=[0.1, 0.1, 0.2, 0.2],
             flip=True, clip=True, steps=[0.0, 0.0], offset=0.5)
    a.update(attrs)
    return {"Input": [_randn(2, 4, 5, 6, seed=1)],
            "Image": [_randn(2, 3, 30, 36, seed=2)]}, a


def _coder_in(code_type, target, var=True, normalized=True):
    d = {"PriorBox": [_boxes(6, 11, 1.0 if normalized else 40.0)],
         "TargetBox": [target]}
    if var:
        d["PriorBoxVar"] = [np.tile(np.array([[0.1, 0.1, 0.2, 0.2]],
                                             np.float32), (6, 1))]
    return d, {"code_type": code_type, "box_normalized": normalized}


def _nms_in(seed, tied=False):
    scores = _rng(seed).rand(2, 3, 20).astype(np.float32)
    if tied:
        scores = np.round(scores * 4) / 4         # tied scores, zeros too
    return {"BBoxes": [_boxes(20, seed + 1, lead=(2,))],
            "Scores": [scores]}, \
        {"score_threshold": 0.05, "nms_top_k": 8,
         "keep_top_k": 40 if tied else 12, "nms_threshold": 0.4,
         "background_label": 0}


def _rois(seed, n=6, size=24.0, off_map=True):
    rois = _boxes(n, seed, size)
    if off_map:
        rois[0] = [30.0, 30.0, 40.0, 44.0]          # wholly off the map
        rois[1] = [-4.0, 2.0, 6.0, 30.0]            # partly off it
    return rois


def _roi_in(seed, x, **attrs):
    n = x.shape[0]
    rois = _rois(seed)
    d = {"X": [x], "ROIs": [rois],
         "BatchId": [_rng(seed).randint(0, n, (rois.shape[0],)).astype(
             np.int64)]}
    return d, attrs


def _quads(seed, n=4):
    r = _rng(seed)
    base = _boxes(n, seed, 20.0)
    jitter = r.rand(n, 4, 2).astype(np.float32) * 2.0
    quads = np.stack([base[:, [0, 1]], base[:, [2, 1]], base[:, [2, 3]],
                      base[:, [0, 3]]], 1) + jitter
    return quads.reshape(n, 8).astype(np.float32)


def _match_in(seed, match_type="bipartite"):
    d = np.round(_rng(seed).rand(2, 4, 9) * 4) / 4    # tied distances
    d[1, 3] = 0.0                                    # a padded gt row
    return {"DistMat": [d.astype(np.float32)]}, \
        {"match_type": match_type, "dist_threshold": 0.3}


def _assign_in(seed, four_d=False, neg=False, ints=True):
    r = _rng(seed)
    match = r.randint(-1, 4, (2, 9)).astype(np.int32)
    if four_d:
        x = _randn(2, 4, 9, 4, seed=seed)
    elif ints:
        x = r.randint(0, 5, (2, 4, 1)).astype(np.int32)
    else:
        x = _randn(2, 4, 3, seed=seed)
    d = {"X": [x], "MatchIndices": [match]}
    if neg:
        negs = np.full((2, 9), -1, np.int32)
        negs[0, :3] = [0, 4, 8]
        negs[1, :2] = [2, 2]
        d["NegIndices"] = [negs]
    return d, {"mismatch_value": 0}


def _mine_in(seed, mining="max_negative"):
    r = _rng(seed)
    loss = (np.round(r.rand(2, 12) * 3) / 3).astype(np.float32)  # ties
    match = r.randint(-1, 3, (2, 12)).astype(np.int32)
    match[match == 2] = -1
    d = {"ClsLoss": [loss], "MatchIndices": [match],
         "MatchDist": [r.rand(2, 12).astype(np.float32)]}
    attrs = {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
             "mining_type": mining, "sample_size": 0}
    if mining == "hard_example":
        d["LocLoss"] = [(np.round(r.rand(2, 12) * 2) / 2).astype(
            np.float32)]
        attrs["sample_size"] = 5
    return d, attrs


def _anchors(h, w, a, stride=8.0):
    lowering = treg.get_lowering("anchor_generator")
    sizes = [16.0, 32.0, 64.0][:a]
    out = lowering(treg.LoweringContext("cpu"),
                   {"Input": [torch.zeros(1, 1, h, w)]},
                   {"anchor_sizes": sizes, "aspect_ratios": [1.0],
                    "stride": [stride, stride]})
    return out["Anchors"][0].numpy(), out["Variances"][0].numpy()


def _proposals_in(seed, tied=False):
    r = _rng(seed)
    n, a, h, w = 2, 3, 4, 5
    scores = r.randn(n, a, h, w).astype(np.float32)
    if tied:
        scores = np.round(scores)                # many tied scores
    anc, var = _anchors(h, w, a)
    return {"Scores": [scores],
            "BboxDeltas": [(r.randn(n, 4 * a, h, w) * 0.3).astype(
                np.float32)],
            "ImInfo": [np.array([[32.0, 40.0, 1.0], [30.0, 36.0, 1.0]],
                                np.float32)],
            "Anchors": [anc], "Variances": [var]}, \
        {"pre_nms_topN": 30, "post_nms_topN": 10, "nms_thresh": 0.5,
         "min_size": 2.0}


def _rpn_in(seed, straddle=0.0):
    anc, _ = _anchors(4, 5, 2)
    anc = anc.reshape(-1, 4)
    anc = np.concatenate([anc, anc[:8]])         # repeated anchors tie
    gt = _boxes(3, seed, 36.0)
    return {"Anchor": [anc], "GtBoxes": [gt],
            "IsCrowd": [np.array([0, 0, 1], np.int32)],
            "ImInfo": [np.array([[32.0, 40.0, 1.0]], np.float32)]}, \
        {"rpn_batch_size_per_im": 16, "rpn_straddle_thresh": straddle,
         "rpn_fg_fraction": 0.5, "rpn_positive_overlap": 0.5,
         "rpn_negative_overlap": 0.3}


def _yolo_loss_in(seed, score=False, smooth=False, ignore=0.5):
    r = _rng(seed)
    n, c, h = 2, 4, 5
    gt = np.concatenate([r.rand(n, 4, 2) * 0.9 + 0.05,
                         r.rand(n, 4, 2) * 0.5 + 0.02], -1).astype(
        np.float32)
    gt[1, 3] = 0.0                               # a padded gt box
    d = {"X": [_randn(n, 3 * (5 + c), h, h, seed=seed) * 0.5],
         "GTBox": [gt], "GTLabel": [r.randint(0, c, (n, 4)).astype(
             np.int32)]}
    if score:
        d["GTScore"] = [r.rand(n, 4).astype(np.float32)]
    return d, {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                           116, 90, 156, 198, 373, 326],
               "anchor_mask": [3, 4, 5], "class_num": c,
               "ignore_thresh": ignore, "downsample_ratio": 16,
               "use_label_smooth": smooth}


def _labels_in(seed, use_random=False):
    gt = _boxes(3, seed, 40.0)
    rois = np.concatenate([_boxes(14, seed + 1, 40.0), gt[:2], gt[:2],
                           _boxes(2, seed + 2, 40.0)])   # repeated RoIs tie
    return {"RpnRois": [rois.astype(np.float32)],
            "GtClasses": [np.array([1, 3, 2], np.int32)],
            "IsCrowd": [np.array([0, 0, 1], np.int32)],
            "GtBoxes": [gt], "ImInfo": [np.array([[40, 40, 1.0]],
                                                 np.float32)]}, \
        {"batch_size_per_im": 16, "fg_fraction": 0.25, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
         "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 5,
         "use_random": use_random}


def _mask_in(seed):
    r = _rng(seed)
    rois = _boxes(6, seed, 30.0)
    centre = r.rand(3, 1, 2) * 20 + 5
    ang = np.sort(r.rand(3, 5) * 2 * np.pi, axis=1)
    rad = r.rand(3, 5, 1) * 6 + 3
    poly = centre + rad * np.stack([np.cos(ang), np.sin(ang)], -1)
    poly[2, 4] = poly[2, 3]                      # a repeated last vertex
    return {"Rois": [rois], "LabelsInt32": [np.array([1, 2, 0, 3, 1, -1],
                                                     np.int32)],
            "GtClasses": [np.array([1, 2, 3], np.int32)],
            "GtSegms": [poly.astype(np.float32)],
            "ImInfo": [np.array([[40, 40, 1.0]], np.float32)],
            "IsCrowd": [np.zeros(3, np.int32)]}, \
        {"num_classes": 4, "resolution": 6}


def _decode_assign_in(seed, var_rows=False, clip=4.135):
    r = _rng(seed)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    scores = r.rand(5, 3).astype(np.float32)
    scores[0] = [0.9, 0.05, 0.05]                # background the best
    return {"PriorBox": [_boxes(5, seed, 40.0)],
            "PriorBoxVar": [np.tile(var, (5, 1)) if var_rows else var],
            "TargetBox": [_randn(5, 12, seed=seed) * 3.0],
            "BoxScore": [scores]}, {"box_clip": clip}


def _fpn_in(seed):
    rois = _boxes(10, seed, 900.0)
    rois[3] = rois[7]                            # repeated RoIs
    return {"FpnRois": [rois]}, {"min_level": 2, "max_level": 5,
                                 "refer_level": 4, "refer_scale": 224}


# case -> (inputs, attrs). The op is the case's name up to "__".
CASES = {
    "prior_box": _prior_in(),
    "prior_box__no_max_steps": _prior_in(max_sizes=[], steps=[6.0, 6.0],
                                         flip=False, clip=False),
    "anchor_generator": ({"Input": [_randn(1, 4, 5, 6, seed=3)]},
                         {"anchor_sizes": [32.0, 64.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "variances": [0.1, 0.1, 0.2, 0.2],
                          "stride": [16.0, 16.0], "offset": 0.5}),
    "density_prior_box": ({"Input": [_randn(1, 4, 4, 5, seed=4)],
                           "Image": [_randn(1, 3, 32, 40, seed=5)]},
                          {"densities": [4, 2], "fixed_sizes": [8.0, 16.0],
                           "fixed_ratios": [1.0, 2.0],
                           "variances": [0.1, 0.1, 0.2, 0.2], "clip": True,
                           "steps": [0.0, 0.0], "offset": 0.5}),
    "box_coder": _coder_in("encode_center_size", _boxes(3, 12)),
    "box_coder__batched_encode": _coder_in("encode_center_size",
                                           _boxes(3, 13, lead=(2,))),
    "box_coder__decode": _coder_in("decode_center_size",
                                   _randn(2, 6, 4, seed=14) * 0.5),
    "box_coder__decode_2d_no_var": _coder_in(
        "decode_center_size", _randn(6, 4, seed=15) * 0.5, var=False),
    "box_coder__pixels": _coder_in("encode_center_size",
                                   _boxes(3, 16, 40.0), normalized=False),
    "iou_similarity": ({"X": [_boxes(5, 21)], "Y": [_boxes(7, 22)]},
                       {"box_normalized": True}),
    "iou_similarity__batched_pixels": ({"X": [_boxes(5, 23, 30.0,
                                                     lead=(2,))],
                                        "Y": [_boxes(7, 24, 30.0)]},
                                       {"box_normalized": False}),
    "yolo_box": ({"X": [_randn(2, 3 * 9, 5, 6, seed=31)],
                  "ImgSize": [np.array([[160, 192], [150, 180]], np.int32)]},
                 {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 4,
                  "conf_thresh": 0.5, "downsample_ratio": 32}),
    "multiclass_nms": _nms_in(41),
    "multiclass_nms__tied_scores": _nms_in(43, tied=True),
    "roi_pool": _roi_in(51, _ties(2, 3, 12, 14, seed=52), pooled_height=3,
                        pooled_width=2, spatial_scale=0.5),
    "roi_pool__no_batch_id": ({"X": [_ties(1, 2, 9, 10, seed=53)],
                               "ROIs": [_rois(54, 4, 18.0, False)]},
                              {"pooled_height": 2, "pooled_width": 3,
                               "spatial_scale": 0.5}),
    "roi_align": _roi_in(61, _randn(2, 3, 10, 12, seed=62), pooled_height=3,
                         pooled_width=4, spatial_scale=0.5,
                         sampling_ratio=2),
    "roi_align__adaptive_samples": _roi_in(
        63, _randn(2, 3, 10, 12, seed=64), pooled_height=2, pooled_width=3,
        spatial_scale=0.5, sampling_ratio=-1),
    "psroi_pool": _roi_in(71, _randn(2, 18, 10, 12, seed=72),
                          output_channels=2, pooled_height=3, pooled_width=3,
                          spatial_scale=0.5),
    "roi_perspective_transform": ({"X": [_randn(2, 3, 10, 12, seed=81)],
                                   "ROIs": [_quads(82)],
                                   "BatchId": [np.array([0, 1, 1, 0],
                                                        np.int64)]},
                                  {"transformed_height": 4,
                                   "transformed_width": 5,
                                   "spatial_scale": 0.5}),
    "bipartite_match": _match_in(91),
    "bipartite_match__per_prediction": _match_in(93, "per_prediction"),
    "bipartite_match__2d": ({"DistMat": [_match_in(95)[0]["DistMat"][0][0]]},
                            {"match_type": "per_prediction",
                             "dist_threshold": 0.3}),
    "target_assign": _assign_in(101),
    "target_assign__encoded_boxes": _assign_in(103, four_d=True),
    "target_assign__negatives": _assign_in(105, neg=True),
    "target_assign__floats_2d": ({"X": [_randn(4, 3, seed=107)],
                                  "MatchIndices": [_assign_in(107)[0][
                                      "MatchIndices"][0]]},
                                 {"mismatch_value": 0}),
    "box_clip": ({"Input": [_randn(2, 5, 4, seed=111) * 30],
                  "ImInfo": [np.array([[20, 30, 1.0], [25, 18, 1.0]],
                                      np.float32)]}, {}),
    "box_clip__2d": ({"Input": [_randn(5, 4, seed=113) * 30],
                      "ImInfo": [np.array([[20, 30, 1.0]], np.float32)]},
                     {}),
    "polygon_box_transform": ({"Input": [_randn(2, 8, 4, 5, seed=121)]}, {}),
    "mine_hard_examples": _mine_in(131),
    "mine_hard_examples__hard_example": _mine_in(133, "hard_example"),
    "generate_proposals": _proposals_in(141),
    "generate_proposals__tied_scores": _proposals_in(143, tied=True),
    "rpn_target_assign": _rpn_in(151),
    "rpn_target_assign__no_straddle": _rpn_in(153, straddle=-1.0),
    "distribute_fpn_proposals": _fpn_in(161),
    "yolov3_loss": _yolo_loss_in(171),
    "yolov3_loss__score_smooth": _yolo_loss_in(173, score=True, smooth=True),
    "yolov3_loss__ignore_off": _yolo_loss_in(175, ignore=1.0),
    "generate_proposal_labels": _labels_in(181),
    "generate_mask_labels": _mask_in(191),
    "box_decoder_and_assign": _decode_assign_in(201),
    "box_decoder_and_assign__rows_no_clip": _decode_assign_in(
        203, var_rows=True, clip=0.0),
}


def _op(case):
    return case.split("__")[0]


def _j(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _t(arrays):
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for k, v in arrays.items()}


def _jax(op, arrays, attrs):
    """The JAX lowering, jitted (one compile in place of one a
    primitive)."""
    return jax.jit(lambda ins: jreg.get_lowering(op)(
        jreg.LoweringContext(), ins, attrs))(_j(arrays))


def _port(op, arrays, attrs, ctx=None):
    return treg.get_lowering(op)(ctx or treg.LoweringContext("cpu"),
                                 _t(arrays), attrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x)


def _check(got, want, err_msg="", tol=TOL, int64=False):
    """`int64`: the JAX lowering asks for int64, which it gives as int32
    (x64 off); the port gives int64."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        assert got.dtype == (np.int64 if int64 else want.dtype), (
            got.dtype, want.dtype, err_msg)
        np.testing.assert_array_equal(got, want, err_msg)
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype, err_msg)
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), err_msg
    bound = tol * (np.abs(want).max() or 1.0)
    assert np.abs(got - want).max() <= bound, (
        err_msg, np.abs(got - want).max(), bound)


def test_the_cases_cover_the_slice():
    """The 23 lowerings of the JAX detection_ops.py, each with a case,
    registered in the port's detection_ops.py with the same no-grad flags;
    the port holds 297 (255 before this slice, 278 with it), none the JAX
    package
    lacks."""
    assert {_op(c) for c in CASES} == DETECTION_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("detection_ops")} == DETECTION_OPS
    assert all(treg._LOWERINGS[op].__module__.endswith("detection_ops")
               for op in DETECTION_OPS)
    for op in DETECTION_OPS:
        assert jreg.is_no_grad(op) == treg.is_no_grad(op), op
    assert {op for op in DETECTION_OPS if not treg.is_no_grad(op)} == \
        set(GRAD_SLOTS)
    assert len(treg._LOWERINGS) == 297
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs = CASES[case]
    want = _jax(_op(case), arrays, attrs)
    got = _port(_op(case), arrays, attrs)
    assert set(got) == set(want)
    for slot, w in want.items():
        assert len(got[slot]) == len(w), slot
        for k, (g, v) in enumerate(zip(got[slot], w)):
            _check(g, v, "%s[%d]" % (slot, k), int64=slot in INT64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_inference_gives_the_forwards_shapes(case):
    """The lowering on meta tensors (the port's build-time shape
    inference) gives each output the shape and dtype of the real run."""
    arrays, attrs = CASES[case]
    meta = treg.infer_outputs(_op(case), {k: [t.to("meta") for t in v]
                                          for k, v in _t(arrays).items()},
                              attrs)
    got = _port(_op(case), arrays, attrs)
    for slot in got:
        for m, g in zip(meta[slot], got[slot]):
            assert m.shape == g.shape, slot
            assert m.dtype == g.dtype, slot


def _grad_cases():
    return sorted(c for c in CASES if _op(c) in GRAD_SLOTS)


@pytest.mark.parametrize("case", _grad_cases())
def test_gradient_matches_jax_vjp(case):
    op = _op(case)
    arrays, attrs = CASES[case]
    x_slot, out_slot = GRAD_SLOTS[op]

    def jfn(x):
        ins = _j(arrays)
        ins[x_slot] = [x]
        return jreg.get_lowering(op)(jreg.LoweringContext(), ins,
                                     attrs)[out_slot][0]
    x = jnp.asarray(arrays[x_slot][0])
    cot = _randn(*jax.eval_shape(jfn, x).shape, seed=99)
    want = jax.jit(lambda x, c: jax.vjp(jfn, x)[1](c)[0])(
        x, jnp.asarray(cot))
    ins = _t(arrays)
    leaf = ins[x_slot][0].clone().requires_grad_(True)
    ins[x_slot] = [leaf]
    got_out = treg.get_lowering(op)(treg.LoweringContext("cpu"), ins,
                                    attrs)[out_slot][0]
    got, = torch.autograd.grad(got_out, leaf, torch.from_numpy(cot))
    _check(got, want, case, GRAD_TOL)


def test_roi_pool_bins_hold_ties_and_empties():
    """The roi_pool case exercises what it is there for: bins with tied
    maxima (the gradient split among them) and empty bins (Out 0, Argmax
    -1), and its gradient splits a bin of four equal values in quarters
    in both packages."""
    arrays, attrs = CASES["roi_pool"]
    out = _port("roi_pool", arrays, attrs)
    assert (out["Argmax"][0] == -1).any()
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, :2, :2] = 1.0
    ins = {"X": [x], "ROIs": [np.array([[0, 0, 1, 1]], np.float32)]}
    a = {"pooled_height": 1, "pooled_width": 1, "spatial_scale": 1.0}
    jg = jax.grad(lambda v: jreg.get_lowering("roi_pool")(
        jreg.LoweringContext(), dict(_j(ins), X=[v]), a)["Out"][0].sum())(
            jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    tg, = torch.autograd.grad(treg.get_lowering("roi_pool")(
        treg.LoweringContext("cpu"), dict(_t(ins), X=[leaf]),
        a)["Out"][0].sum(), leaf)
    quarter = np.where(x > 0, 0.25, 0.0)
    np.testing.assert_allclose(np.asarray(jg), quarter)
    np.testing.assert_allclose(tg.numpy(), quarter)


def test_roi_pool_never_builds_the_bin_mask():
    """At a chunk of one RoI the largest tensor roi_pool builds is one
    RoI's [C, H, W] map, not the JAX lowering's [R, C, ph, pw, H, W]
    broadcast; the values stay the JAX ones."""
    arrays, attrs = CASES["roi_pool"]
    want = _jax("roi_pool", arrays, attrs)
    old = detection_ops._ROI_CHUNK_ELEMENTS
    detection_ops._ROI_CHUNK_ELEMENTS = 1
    try:
        got = _port("roi_pool", arrays, attrs)
    finally:
        detection_ops._ROI_CHUNK_ELEMENTS = old
    _check(got["Out"][0], want["Out"][0])
    _check(got["Argmax"][0], want["Argmax"][0], int64=True)


@pytest.mark.parametrize("n,k", [(12, 5), (40, 40), (7, 1)])
def test_top_k_orders_ties_as_jax_does(n, k):
    """top_k on vectors full of ties (and -inf) gives jax.lax.top_k's
    values and indices: the lower index first."""
    x = np.round(_rng(n).randn(3, n)).astype(np.float32)
    x[0, ::3] = -np.inf
    x[1] = 0.0
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = common.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


_SIGNED = np.array([[0.0, -0.0, np.nan, 1.0, -np.nan, -np.inf, np.inf, 1.0,
                     -0.0, 0.0, -np.nan, np.nan],
                    [-0.0, 0.0, 0.0, -0.0, 2.0, -2.0, 0.0, -0.0, 2.0, -2.0,
                     -0.0, 0.0]], np.float32)


@pytest.mark.parametrize("k", [3, 12])
def test_top_k_orders_signed_zeros_and_nans_as_jax(k):
    """common.top_k, which the ranking lowerings, the top_k op and
    beam_search share, on -0.0 beside +0.0 and NaN of both signs:
    jax.lax.top_k's total order (+NaN first, -NaN last, +0.0 above
    -0.0), the same bits and indices."""
    jv, ji = jax.lax.top_k(jnp.asarray(_SIGNED), k)
    tv, ti = common.top_k(torch.from_numpy(_SIGNED), k)
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("axis", [0, 1])
def test_argsort_orders_signed_zeros_and_nans_as_jnp(axis):
    """common.argsort takes -0.0 and +0.0 as equal and puts NaN of either
    sign last, stably, as jnp.argsort does (unlike top_k's total order)."""
    want = np.asarray(jnp.argsort(jnp.asarray(_SIGNED), axis=axis))
    got = common.argsort(torch.from_numpy(_SIGNED), axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_tied_cases_hold_ties():
    """Each ranking case ranks tied values: the ops' inputs repeat."""
    nms = CASES["multiclass_nms__tied_scores"][0]["Scores"][0]
    assert len(np.unique(nms)) < nms.size // 4
    mine = CASES["mine_hard_examples"][0]["ClsLoss"][0]
    assert len(np.unique(mine)) <= 4
    prop = CASES["generate_proposals__tied_scores"][0]["Scores"][0]
    assert len(np.unique(prop)) < prop.size // 4
    out = _port("multiclass_nms", *CASES["multiclass_nms__tied_scores"])
    labels = out["Out"][0][..., 0]
    assert (labels == -1).any()          # zero-score padding rows tie


def test_generate_proposal_labels_random_keeps_the_invariants():
    """use_random=True jitters the scores from the run's generator: the
    sampled rows keep the deterministic run's counts, fg cap, thresholds
    and targets of their own RoIs, and two runs from one seed agree."""
    arrays, attrs = _labels_in(181, use_random=True)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        ctx = treg.LoweringContext("cpu", g)
        return _port("generate_proposal_labels", arrays, attrs, ctx)
    a, b = run(3), run(3)
    for slot in a:
        assert torch.equal(a[slot][0], b[slot][0]), slot
    det = _port("generate_proposal_labels", arrays,
                dict(attrs, use_random=False))
    lab, dlab = a["LabelsInt32"][0], det["LabelsInt32"][0]
    assert int((lab > 0).sum()) == int((dlab > 0).sum()) <= 4
    assert int((lab >= 0).sum()) == int((dlab >= 0).sum())
    gt = torch.from_numpy(arrays["GtBoxes"][0])
    iou = detection_ops.iou_matrix(a["Rois"][0], gt, normalized=False)
    iou[:, 2] = 0.0                                   # the crowd box
    best = iou.amax(dim=1)
    assert bool((best[lab > 0] >= 0.5).all())
    assert bool((best[lab == 0] < 0.5).all())
