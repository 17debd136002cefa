"""Detection layers (the port's counterpart of
``paddle_tpu/fluid/layers/detection.py``; reference:
python/paddle/fluid/layers/detection.py): the same 26 layers with the same
signatures, ops, slots and attrs. ``ssd_loss``, ``detection_output`` and
``multi_box_head`` build the JAX package's programs op for op;
``detection_map`` appends the host op of ``fluid/host_ops.py``.
Layouts are the JAX package's dense, padded ones: ground truth [B, G, 4]
with label -1 (or zero boxes) on padding rows, detections [B, K, 6]
(label, score, x1, y1, x2, y2) with label -1 on padding rows."""
from ..layer_helper import LayerHelper

__all__ = [
    "box_decoder_and_assign", "detection_map", "multi_box_head",
    "roi_perspective_transform", "generate_proposal_labels",
    "generate_mask_labels", "prior_box", "box_coder", "iou_similarity",
    "multiclass_nms", "yolo_box", "ssd_loss", "detection_output",
    "yolov3_loss", "density_prior_box", "bipartite_match", "target_assign",
    "box_clip", "polygon_box_transform", "roi_pool", "roi_align",
    "psroi_pool", "anchor_generator", "generate_proposals",
    "rpn_target_assign", "distribute_fpn_proposals"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.0],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", input=input, name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype,
                                                      stop_gradient=True)
    variances = helper.create_variable_for_type_inference(input.dtype,
                                                          stop_gradient=True)
    helper.append_op(type="prior_box",
                     inputs={"Input": [input], "Image": [image]},
                     outputs={"Boxes": [boxes], "Variances": [variances]},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios),
                            "variances": list(variance), "flip": flip,
                            "clip": clip, "steps": list(steps),
                            "offset": offset})
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    helper = LayerHelper("box_coder", input=prior_box, name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized, "axis": axis})
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    stop_gradient=True)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"box_normalized": box_normalized})
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    helper = LayerHelper("yolo_box", input=x, name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype,
                                                      stop_gradient=True)
    scores = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="yolo_box",
                     inputs={"X": [x], "ImgSize": [img_size]},
                     outputs={"Boxes": [boxes], "Scores": [scores]},
                     attrs={"anchors": list(anchors), "class_num": class_num,
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    return boxes, scores


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    helper = LayerHelper("multiclass_nms", input=bboxes, name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype,
                                                    stop_gradient=True)
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": background_label})
    return out


def _simple_op(helper_name, op_type, inputs, attrs, out_slots, dtype,
               stop_gradient=True):
    """Append one op and create its output vars (detection boilerplate)."""
    any_in = next(iter(inputs.values()))[0]
    helper = LayerHelper(helper_name, input=any_in)
    outs = {}
    ret = []
    for slot in out_slots:
        v = helper.create_variable_for_type_inference(
            dtype, stop_gradient=stop_gradient)
        outs[slot] = [v]
        ret.append(v)
    helper.append_op(type=op_type, inputs=inputs, outputs=outs, attrs=attrs)
    return ret[0] if len(ret) == 1 else tuple(ret)


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    return _simple_op("bipartite_match", "bipartite_match",
                      {"DistMat": [dist_matrix]},
                      {"match_type": match_type,
                       "dist_threshold": dist_threshold},
                      ["ColToRowMatchIndices", "ColToRowMatchDist"],
                      dist_matrix.dtype)


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    return _simple_op("target_assign", "target_assign", inputs,
                      {"mismatch_value": mismatch_value or 0},
                      ["Out", "OutWeight"], input.dtype)


def box_clip(input, im_info, name=None):
    return _simple_op("box_clip", "box_clip",
                      {"Input": [input], "ImInfo": [im_info]}, {},
                      ["Output"], input.dtype)


def polygon_box_transform(input, name=None):
    return _simple_op("polygon_box_transform", "polygon_box_transform",
                      {"Input": [input]}, {}, ["Output"], input.dtype)


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             batch_id=None):
    inputs = {"X": [input], "ROIs": [rois]}
    if batch_id is not None:
        inputs["BatchId"] = [batch_id]
    out, _argmax = _simple_op(
        "roi_pool", "roi_pool", inputs,
        {"pooled_height": pooled_height, "pooled_width": pooled_width,
         "spatial_scale": spatial_scale}, ["Out", "Argmax"], input.dtype,
        stop_gradient=False)
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, batch_id=None, name=None):
    inputs = {"X": [input], "ROIs": [rois]}
    if batch_id is not None:
        inputs["BatchId"] = [batch_id]
    return _simple_op(
        "roi_align", "roi_align", inputs,
        {"pooled_height": pooled_height, "pooled_width": pooled_width,
         "spatial_scale": spatial_scale, "sampling_ratio": sampling_ratio},
        ["Out"], input.dtype, stop_gradient=False)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, batch_id=None, name=None):
    inputs = {"X": [input], "ROIs": [rois]}
    if batch_id is not None:
        inputs["BatchId"] = [batch_id]
    return _simple_op(
        "psroi_pool", "psroi_pool", inputs,
        {"output_channels": output_channels, "spatial_scale": spatial_scale,
         "pooled_height": pooled_height, "pooled_width": pooled_width},
        ["Out"], input.dtype, stop_gradient=False)


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    return _simple_op(
        "anchor_generator", "anchor_generator", {"Input": [input]},
        {"anchor_sizes": list(anchor_sizes), "aspect_ratios":
         list(aspect_ratios), "variances": list(variance),
         "stride": list(stride), "offset": offset},
        ["Anchors", "Variances"], input.dtype)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    rois, probs, num = _simple_op(
        "generate_proposals", "generate_proposals",
        {"Scores": [scores], "BboxDeltas": [bbox_deltas],
         "ImInfo": [im_info], "Anchors": [anchors],
         "Variances": [variances]},
        {"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
         "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta},
        ["RpnRois", "RpnRoiProbs", "RpnRoisNum"], scores.dtype)
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    loc_idx, score_idx, tgt_lbl, tgt_bbox, inside_w = _simple_op(
        "rpn_target_assign", "rpn_target_assign",
        {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
         "IsCrowd": [is_crowd], "ImInfo": [im_info]},
        {"rpn_batch_size_per_im": rpn_batch_size_per_im,
         "rpn_straddle_thresh": rpn_straddle_thresh,
         "rpn_fg_fraction": rpn_fg_fraction,
         "rpn_positive_overlap": rpn_positive_overlap,
         "rpn_negative_overlap": rpn_negative_overlap},
        ["LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
         "BBoxInsideWeight"], gt_boxes.dtype)
    return loc_idx, score_idx, tgt_bbox, tgt_lbl, inside_w


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", input=fpn_rois)
    nlvl = max_level - min_level + 1
    multi = [helper.create_variable_for_type_inference(
        fpn_rois.dtype, stop_gradient=True) for _ in range(nlvl)]
    nums = [helper.create_variable_for_type_inference(
        "int32", stop_gradient=True) for _ in range(nlvl)]
    restore = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(type="distribute_fpn_proposals",
                     inputs={"FpnRois": [fpn_rois]},
                     outputs={"MultiFpnRois": multi,
                              "MultiLevelRoIsNum": nums,
                              "RestoreIndex": [restore]},
                     attrs={"min_level": min_level, "max_level": max_level,
                            "refer_level": refer_level,
                            "refer_scale": refer_scale})
    return multi, restore


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """SSD multibox loss (reference: python/paddle/fluid/layers/detection.py
    ssd_loss — match priors to gts, mine hard negatives, smooth-l1 loc loss +
    softmax conf loss). Built from the same op pipeline the reference uses:
    iou_similarity → bipartite_match → target_assign → mine_hard_examples."""
    from . import nn, tensor, ops
    from .nn import softmax_with_cross_entropy

    iou = iou_similarity(gt_box, prior_box)            # [B, G, P]
    match_idx, match_dist = bipartite_match(iou, match_type,
                                            overlap_threshold)
    # conf loss per prior against matched labels (bg for mismatches)
    tgt_lbl, _w = target_assign(gt_label, match_idx,
                                mismatch_value=background_label)
    conf_loss_all = softmax_with_cross_entropy(
        confidence, tensor.cast(tgt_lbl, "int64"))     # [B, P, 1]
    cl = nn.squeeze(conf_loss_all, axes=[-1])
    neg_idx, upd_idx = _simple_op(
        "mine_hard_examples", "mine_hard_examples",
        {"ClsLoss": [cl], "MatchIndices": [match_idx],
         "MatchDist": [match_dist]},
        {"neg_pos_ratio": neg_pos_ratio, "neg_dist_threshold": neg_overlap,
         "mining_type": mining_type, "sample_size": sample_size or 0},
        ["NegIndices", "UpdatedMatchIndices"], "int32")
    # loc loss on matched priors: encode gt vs prior, elementwise smooth-l1
    enc_gt, loc_w = target_assign(
        box_coder(prior_box, prior_box_var, gt_box), match_idx)
    d = ops.abs(location - enc_gt)
    m = nn.clip(d, 0.0, 1.0)
    loc_l = 0.5 * m * m + (d - m)     # 0.5d² below 1, |d|-0.5 above
    loc_loss = nn.reduce_sum(loc_l * loc_w)
    # conf loss: matched + mined negatives
    _lbl2, conf_w = target_assign(gt_label, upd_idx,
                                  negative_indices=neg_idx,
                                  mismatch_value=background_label)
    conf_loss = nn.reduce_sum(cl * nn.squeeze(conf_w, axes=[-1]))
    npos = nn.reduce_sum(loc_w) + 1e-6
    total = loc_loss_weight * loc_loss + conf_loss_weight * conf_loss
    if normalize:
        total = total / npos
    return total


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold,
                          background_label=background_label)


def yolov3_loss(x, gtbox=None, gtlabel=None, anchors=None, anchor_mask=None,
                class_num=None, ignore_thresh=None, downsample_ratio=None,
                gtscore=None, use_label_smooth=False, name=None,
                gt_box=None, gt_label=None, gt_score=None):
    # reference 1.3 argument names are gtbox/gtlabel/gtscore; the underscored
    # forms are kept as aliases
    gtbox = gtbox if gtbox is not None else gt_box
    gtlabel = gtlabel if gtlabel is not None else gt_label
    gtscore = gtscore if gtscore is not None else gt_score
    inputs = {"X": [x], "GTBox": [gtbox], "GTLabel": [gtlabel]}
    if gtscore is not None:
        inputs["GTScore"] = [gtscore]
    return _simple_op(
        "yolov3_loss", "yolov3_loss", inputs,
        {"anchors": list(anchors), "anchor_mask": list(anchor_mask),
         "class_num": class_num, "ignore_thresh": ignore_thresh,
         "downsample_ratio": downsample_ratio,
         "use_label_smooth": use_label_smooth},
        ["Loss", "ObjectnessMask", "GTMatchMask"], x.dtype,
        stop_gradient=False)[0]


def density_prior_box(input, image=None, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=[0.1, 0.1, 0.2, 0.2],
                      clip=False, steps=[0.0, 0.0], offset=0.5,
                      flatten_to_2d=False, name=None):
    boxes, var = _simple_op(
        "density_prior_box", "density_prior_box",
        {"Input": [input], "Image": [image]},
        {"densities": list(densities or []),
         "fixed_sizes": list(fixed_sizes or []),
         "fixed_ratios": list(fixed_ratios or [1.0]),
         "variances": list(variance), "clip": clip, "steps": list(steps),
         "offset": offset}, ["Boxes", "Variances"], input.dtype)
    if flatten_to_2d:
        from . import nn
        boxes = nn.reshape(boxes, shape=[-1, 4])
        var = nn.reshape(var, shape=[-1, 4])
    return boxes, var


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    """Decode per-class boxes and pick the best-scoring class's box
    (reference box_decoder_and_assign_op.cc, Cascade R-CNN)."""
    helper = LayerHelper("box_decoder_and_assign", input=prior_box, name=name)
    decoded = helper.create_variable_for_type_inference(prior_box.dtype)
    assigned = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(
        type="box_decoder_and_assign",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box], "BoxScore": [box_score]},
        outputs={"DecodeBox": [decoded], "OutputAssignBox": [assigned]},
        attrs={"box_clip": box_clip})
    return decoded, assigned


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """mAP op over detection results (reference detection_map_op.cc; runs as
    a host op — data-dependent matching)."""
    helper = LayerHelper("detection_map", input=detect_res)
    map_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    outputs = {"MAP": [map_out]}
    if input_states is not None:
        # evaluator accumulation (reference detection_map_op.cc state
        # slots): carry per-class gt counts + scored tp/fp rows across
        # batches; out_states default to updating the same vars in place
        pos, tp, fp = input_states
        inputs.update({"PosCount": [pos], "TruePos": [tp],
                       "FalsePos": [fp]})
        if has_state is not None:
            inputs["HasState"] = [has_state]
        pos_o, tp_o, fp_o = out_states or input_states
        outputs.update({"AccumPosCount": [pos_o], "AccumTruePos": [tp_o],
                        "AccumFalsePos": [fp_o]})
    helper.append_op(
        type="detection_map",
        inputs=inputs,
        outputs=outputs,
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    return map_out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    """Perspective-warp ROIs to a fixed size (reference
    roi_perspective_transform_op.cc)."""
    helper = LayerHelper("roi_perspective_transform", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_perspective_transform",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head: per-feature-map prior boxes + loc/conf convs,
    flattened and concatenated (reference layers/detection.py
    multi_box_head). Returns (mbox_locs, mbox_confs, boxes, variances)."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers

    n_layer = len(inputs)
    if min_sizes is None:
        # evenly spaced ratios between min_ratio and max_ratio (reference
        # formula), first layer gets base_size * 10%
        assert min_ratio is not None and max_ratio is not None
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2)) \
            if n_layer > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_layer - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_layer - 1]

    locs, confs, boxes_list, vars_list = [], [], [], []
    for i, x in enumerate(inputs):
        min_s = min_sizes[i]
        max_s = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) else \
            [aspect_ratios[i]]
        st = steps[i] if steps else (step_w[i] if step_w else 0.0,
                                     step_h[i] if step_h else 0.0)
        if not isinstance(st, (list, tuple)):
            st = (st, st)
        box, var = prior_box(
            x, image,
            min_sizes=[min_s] if not isinstance(min_s, (list, tuple))
            else list(min_s),
            max_sizes=[max_s] if max_s and not isinstance(
                max_s, (list, tuple)) else (list(max_s) if max_s else None),
            aspect_ratios=ar, variance=variance, flip=flip, clip=clip,
            steps=list(st), offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        num_priors_per_loc = box.shape[2] if len(box.shape) == 4 else \
            (len(ar) * (2 if flip else 1) + (1 if max_s else 0) + 1)
        # infer priors per location from the flattened prior count
        hw = x.shape[2] * x.shape[3]
        num_boxes = box.shape[0] if len(box.shape) == 2 else hw
        num_priors = (num_boxes // hw) if len(box.shape) == 2 else \
            num_priors_per_loc

        loc = nn_layers.conv2d(x, num_filters=num_priors * 4,
                               filter_size=kernel_size, padding=pad,
                               stride=stride)
        loc = nn_layers.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn_layers.reshape(loc, shape=[0, -1, 4])
        locs.append(loc)
        conf = nn_layers.conv2d(x, num_filters=num_priors * num_classes,
                                filter_size=kernel_size, padding=pad,
                                stride=stride)
        conf = nn_layers.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn_layers.reshape(conf, shape=[0, -1, num_classes])
        confs.append(conf)
        boxes_list.append(nn_layers.reshape(box, shape=[-1, 4]))
        vars_list.append(nn_layers.reshape(var, shape=[-1, 4]))

    mbox_locs = tensor_layers.concat(locs, axis=1)
    mbox_confs = tensor_layers.concat(confs, axis=1)
    boxes = tensor_layers.concat(boxes_list, axis=0)
    variances = tensor_layers.concat(vars_list, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                             class_nums=None, use_random=True):
    """Sample fg/bg rois vs ground truth for Fast R-CNN training (reference
    generate_proposal_labels_op.cc; host op — data-dependent sampling)."""
    helper = LayerHelper("generate_proposal_labels", input=rpn_rois)
    mk = lambda dt: helper.create_variable_for_type_inference(
        dt, stop_gradient=True)
    rois = mk(rpn_rois.dtype)
    labels_int32 = mk("int32")
    bbox_targets = mk(rpn_rois.dtype)
    bbox_inside_weights = mk(rpn_rois.dtype)
    bbox_outside_weights = mk(rpn_rois.dtype)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
                "ImInfo": [im_info]},
        outputs={"Rois": [rois], "LabelsInt32": [labels_int32],
                 "BboxTargets": [bbox_targets],
                 "BboxInsideWeights": [bbox_inside_weights],
                 "BboxOutsideWeights": [bbox_outside_weights]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums, "use_random": use_random})
    return (rois, labels_int32, bbox_targets, bbox_inside_weights,
            bbox_outside_weights)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    """Mask targets for Mask R-CNN (reference generate_mask_labels_op.cc;
    host op — polygon rasterization)."""
    helper = LayerHelper("generate_mask_labels", input=rois)
    mk = lambda dt: helper.create_variable_for_type_inference(
        dt, stop_gradient=True)
    mask_rois = mk(rois.dtype)
    roi_has_mask_int32 = mk("int32")
    mask_int32 = mk("int32")
    helper.append_op(
        type="generate_mask_labels",
        inputs={"ImInfo": [im_info], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
                "Rois": [rois], "LabelsInt32": [labels_int32]},
        outputs={"MaskRois": [mask_rois],
                 "RoiHasMaskInt32": [roi_has_mask_int32],
                 "MaskInt32": [mask_int32]},
        attrs={"num_classes": num_classes, "resolution": resolution})
    return mask_rois, roi_has_mask_int32, mask_int32
