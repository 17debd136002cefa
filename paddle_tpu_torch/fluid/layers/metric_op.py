"""Metric layers (the port's counterpart of
``paddle_tpu/fluid/layers/metric_op.py``): accuracy and auc."""
from ..initializer import Constant
from ..layer_helper import LayerHelper
from .nn import topk

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` against ``label``: a top_k op, then an
    accuracy op. Returns the float32 accuracy; Correct and Total are int32."""
    helper = LayerHelper("accuracy", input=input)
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC. Returns (auc, [auc], [stat_pos, stat_neg]): the
    histograms are int64 persistables, zeroed by the startup program and
    accumulated by every run."""
    helper = LayerHelper("auc", input=input)
    auc_out = helper.create_variable_for_type_inference("float64",
                                                        stop_gradient=True)
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1],
        name=helper.name + "_stat_pos")
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="int64", shape=[num_thresholds + 1],
        name=helper.name + "_stat_neg")
    for var in (stat_pos, stat_neg):
        helper.set_variable_initializer(var, Constant(0.0))
    helper.append_op(type="auc",
                     inputs={"Predict": [input], "Label": [label],
                             "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [auc_out], [stat_pos, stat_neg]
