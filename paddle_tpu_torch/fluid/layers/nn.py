"""Neural-network layers (the port's counterpart of
``paddle_tpu/fluid/layers/nn.py``): the layer functions the Transformer,
BERT, DeepFM, ResNet, VGG, SE-ResNeXt and the MNIST MLP call, the
elementwise, logical, activation and reduction layers, clipping, label
smoothing, cos_sim and the global step counter of the learning-rate
schedules, the losses of the Fluid book and of ``fluid.layers`` (the
cross-entropy over probabilities, the squared error, log, Huber, KL,
n-pair, teacher-student, smooth L1, BPR, rank, margin-rank, dice and
hinge losses), l2_normalize, the tensor layers (split, stack,
gather, scatter, pads, crops, channel moves, the random layers, sum,
mul, ...) and the rest of the NN layers (the transposed and 3-D
convolutions, 3-D and adaptive pooling, group, data and spectral norms,
LRN, the resizes, the spatial transformer's affine_grid and
grid_sampler, the sequence-shaped and pairwise layers, hsigmoid and
sampled softmax), lod_reset and the recurrent layers (dynamic_lstm,
dynamic_lstmp, dynamic_gru, gru_unit, lstm_unit, the cuDNN-style lstm)
and the decoding layers (linear_chain_crf, crf_decoding, nce, beam_search,
beam_search_decode), the CTC layers (warpctc, ctc_greedy_decoder,
edit_distance), index pooling (adaptive_pool2d(require_index=True),
unpool, spp) and mean_iou, with the same signatures and the same ops,
slots and attrs. switch_moe waits for ROADMAP Queue 1 item 7: it raises."""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "topk",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "square_error_cost", "l2_normalize", "log_loss",
    "huber_loss", "kldiv_loss", "npair_loss", "teacher_student_sigmoid_loss",
    "smooth_l1", "bpr_loss", "rank_loss", "margin_rank_loss", "dice_loss",
    "hinge_loss",
    "matmul", "transpose", "reshape", "flatten", "slice", "one_hot", "mean",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "clip", "clip_by_norm", "maxout", "prelu", "relu", "relu6", "leaky_relu",
    "elu", "log", "pow", "brelu", "soft_relu", "swish", "hard_sigmoid",
    "selu", "sigmoid", "square", "reduce_sum", "reduce_mean", "reduce_max",
    "reduce_min", "reduce_prod", "scale", "label_smooth", "cos_sim",
    "autoincreased_step_counter", "add_position_encoding",
    "squeeze", "unsqueeze", "stack", "unstack", "expand", "mul", "split",
    "shape", "pad", "pad2d", "pad_constant_like", "gather", "scatter",
    "random_crop", "crop", "space_to_depth", "shuffle_channel",
    "uniform_random_batch_size_like", "gaussian_random",
    "gaussian_random_batch_size_like", "sampling_id", "sum", "multiplex",
    "reverse", "merge_selected_rows", "get_tensor_from_selected_rows",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d",
    "adaptive_pool2d", "adaptive_pool3d", "group_norm", "data_norm",
    "affine_channel", "lrn", "image_resize", "resize_bilinear",
    "resize_nearest", "image_resize_short", "grid_sampler", "affine_grid",
    "im2sequence", "bilinear_tensor_product", "row_conv", "spectral_norm",
    "fsp_matrix", "similarity_focus", "tree_conv", "hsigmoid",
    "sampled_softmax_with_cross_entropy", "switch_moe", "spp", "unpool",
    "lod_reset", "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
    "lstm_unit", "lstm", "linear_chain_crf", "crf_decoding", "nce",
    "beam_search", "beam_search_decode", "warpctc", "ctc_greedy_decoder",
    "edit_distance", "mean_iou", "chunk_eval", "hash", "py_func",
]


def _single_out(helper, op_type, inputs, attrs=None, dtype=None, slot="Out"):
    out = helper.create_variable_for_type_inference(
        dtype=dtype or helper.input_dtype())
    helper.append_op(type=op_type, inputs=inputs, outputs={slot: [out]},
                     attrs=attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected (reference: layers/nn.py fc) — mul per input + sum +
    bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in zip(helper.multiple_input(),
                                 helper.multiple_param_attr(
                                     len(helper.multiple_input()))):
        input_shape = input_var.shape
        param_shape = [
            int(np.prod([abs(d) for d in input_shape[num_flatten_dims:]]))
        ] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="mul",
                         inputs={"X": [input_var], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Lookup table (reference: layers/nn.py embedding / lookup_table_op.cc).
    The ids' lengths (``seq_length_var``) carry on to the output."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=list(size),
                                dtype=dtype, is_bias=False)
    if is_distributed:
        w.is_distributed = True
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"Ids": [input], "W": [w]},
                     outputs={"Out": [tmp]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx,
                            "remote_prefetch": False})
    if getattr(input, "seq_length_var", None) is not None:
        tmp.seq_length_var = input.seq_length_var
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """2-D convolution over NCHW input with an OIHW filter (default init
    Normal(0, sqrt(2 / fan_in))), then the bias over channels and ``act``.
    groups equal to the channels with num_filters a multiple of them makes
    the reference's ``depthwise_conv2d`` op (the default groups of 1 over
    a one-channel image does too)."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = num_channels * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    op_type = "depthwise_conv2d" if (groups == num_channels and
                                     num_filters % num_channels == 0) \
        else "conv2d"
    helper.append_op(type=op_type,
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True):
    helper = LayerHelper("pool2d", input=input, name=name)
    pool_size = [pool_size] * 2 if isinstance(pool_size, int) \
        else list(pool_size)
    pool_stride = [pool_stride] * 2 if isinstance(pool_stride, int) \
        else list(pool_stride)
    pool_padding = [pool_padding] * 2 if isinstance(pool_padding, int) \
        else list(pool_padding)
    return _single_out(helper, "pool2d", {"X": [input]},
                       {"pooling_type": pool_type, "ksize": pool_size,
                        "strides": pool_stride, "paddings": pool_padding,
                        "global_pooling": global_pooling,
                        "ceil_mode": ceil_mode, "exclusive": exclusive})


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               fuse_with_relu=False, use_global_stats=False):
    """Batch normalization over the channel axis (1, or the last for NHWC):
    f32 scale and bias (init 1 and 0) and non-trainable f32 running mean and
    variance (init 0 and 1, named by moving_mean_name and
    moving_variance_name), which the op updates in place; then ``act``."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    input_shape = input.shape
    channel_num = input_shape[-1] if data_layout == "NHWC" else input_shape[1]
    param_shape = [channel_num]
    scale = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype="float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype="float32", is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False), shape=param_shape, dtype="float32")
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False), shape=param_shape, dtype="float32")
    saved_mean = helper.create_variable_for_type_inference("float32",
                                                           stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference("float32",
                                                          stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    input_shape = input.shape
    param_shape = [int(np.prod([abs(d) for d in
                                input_shape[begin_norm_axis:]]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype="float32",
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference("float32",
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8",
                                                     stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0,
                            "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", input=input, name=name)
    return _single_out(helper, "softmax", {"X": [input]})


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=False,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy", input=logits)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    lse_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss],
                              "LSE": [lse_out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", input=x, name=name)
    return _single_out(helper, "matmul", {"X": [x], "Y": [y]},
                       {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                        "alpha": float(alpha)}, dtype=x.dtype)


def topk(input, k, name=None):
    """(values, int64 indices) of the k largest entries of each row."""
    helper = LayerHelper("top_k", input=input, name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    return values, indices


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", input=x, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def mean(x, name=None):
    helper = LayerHelper("mean", input=x, name=name)
    return _single_out(helper, "mean", {"X": [x]}, dtype=x.dtype)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The global step counter: a persistable int64 [1] var (default
    ``@STEP_COUNTER@``) that the startup program fills with begin - step
    and an ``increment`` op at the head of the main program advances by
    ``step`` every run, so its first run reads ``begin``."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.main_program.global_block().create_var(
        name=counter_name, dtype="int64", shape=(1,), persistable=True)
    if not helper.startup_program.global_block().has_var(counter_name):
        sb = helper.startup_program.global_block()
        sb.create_var(name=counter_name, dtype="int64", shape=(1,),
                      persistable=True)
        sb.append_op(type="fill_constant", outputs={"Out": [counter_name]},
                     attrs={"shape": [1], "value": float(begin - step),
                            "dtype": "int64"})
    helper.main_program.global_block().prepend_op(
        type="increment", inputs={"X": [counter_name]},
        outputs={"Out": [counter_name]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, input=x, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")
elementwise_mod = _elementwise_layer("elementwise_mod")
elementwise_floordiv = _elementwise_layer("elementwise_floordiv")


def _logical_layer(op_type, binary=True):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference("bool")
        inputs = {"X": [x]}
        if binary:
            inputs["Y"] = [y]
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        return out
    layer.__name__ = op_type
    return layer


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", binary=False)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", input=x, name=name)
    return _single_out(helper, "clip", {"X": [x]},
                       {"min": float(min), "max": float(max)}, dtype=x.dtype)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", input=x, name=name)
    return _single_out(helper, "clip_by_norm", {"X": [x]},
                       {"max_norm": float(max_norm)}, dtype=x.dtype)


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", input=x, name=name)
    return _single_out(helper, "maxout", {"X": [x]}, {"groups": groups},
                       dtype=x.dtype)


def prelu(x, mode, param_attr=None, name=None):
    """where(x > 0, x, alpha * x) with a float32 alpha parameter (init
    0.25): one value ("all"), one a channel ("channel") or one an element
    of a sample ("element")."""
    helper = LayerHelper("prelu", input=x, param_attr=param_attr, name=name)
    if mode not in ("all", "channel", "element"):
        raise ValueError("mode should be one of all, channel, element")
    alpha_shape = [1]
    if mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    elif mode == "element":
        alpha_shape = list(x.shape)
        alpha_shape[0] = 1
    alpha = helper.create_parameter(attr=helper.param_attr, shape=alpha_shape,
                                    dtype="float32",
                                    default_initializer=Constant(0.25))
    return _single_out(helper, "prelu", {"X": [x], "Alpha": [alpha]},
                       {"mode": mode}, dtype=x.dtype)


def _act_layer(op_type, attr_names=()):
    """An activation layer whose attrs (``attr_names``) come positionally
    or by keyword."""
    def layer(x, *args, **kwargs):
        name = kwargs.pop("name", None)
        helper = LayerHelper(op_type, input=x, name=name)
        attrs = {}
        for i, a in enumerate(attr_names):
            if i < len(args):
                attrs[a] = args[i]
            elif a in kwargs:
                attrs[a] = kwargs[a]
        return _single_out(helper, op_type, {"X": [x]}, attrs, dtype=x.dtype)
    layer.__name__ = op_type
    return layer


relu = _act_layer("relu")
relu6 = _act_layer("relu6", ("threshold",))
leaky_relu = _act_layer("leaky_relu", ("alpha",))
elu = _act_layer("elu", ("alpha",))
log = _act_layer("log")
pow = _act_layer("pow", ("factor",))
brelu = _act_layer("brelu", ("t_min", "t_max"))
soft_relu = _act_layer("soft_relu", ("threshold",))
swish = _act_layer("swish", ("beta",))
hard_sigmoid = _act_layer("hard_sigmoid", ("slope", "offset"))
selu = _act_layer("selu", ("scale", "alpha"))
sigmoid = _act_layer("sigmoid")
square = _act_layer("square")


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        """Over ``dim`` (an int or a list), or over everything when dim is
        None."""
        helper = LayerHelper(op_type, input=input, name=name)
        if dim is None:
            attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"reduce_all": False, "dim": list(dims),
                     "keep_dim": keep_dim}
        return _single_out(helper, op_type, {"X": [input]}, attrs,
                           dtype=input.dtype)
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", input=label, name=name)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    return _single_out(helper, "label_smooth", inputs,
                       {"epsilon": float(epsilon)}, dtype=dtype)


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", input=X)
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype,
                                                      stop_gradient=True)
    ynorm = helper.create_variable_for_type_inference(X.dtype,
                                                      stop_gradient=True)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", input=input)
    return _single_out(helper, "slice", {"Input": [input]},
                       {"axes": list(axes), "starts": list(starts),
                        "ends": list(ends)}, dtype=input.dtype)


def one_hot(input, depth):
    helper = LayerHelper("one_hot", input=input)
    return _single_out(helper, "one_hot", {"X": [input]}, {"depth": depth},
                       dtype="float32")


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", input=x,
                         name=name)
    return _single_out(helper, "sigmoid_cross_entropy_with_logits",
                       {"X": [x], "Label": [label]},
                       {"ignore_index": ignore_index, "normalize": normalize},
                       dtype=x.dtype)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def add_position_encoding(input, alpha, beta, name=None):
    helper = LayerHelper("add_position_encoding", input=input, name=name)
    return _single_out(helper, "add_position_encoding", {"X": [input]},
                       {"alpha": alpha, "beta": beta}, dtype=input.dtype)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """The cross-entropy of probabilities ``input`` (a softmax's output)
    against hard int64 labels [N, 1] or soft ones: loss [N, 1]."""
    helper = LayerHelper("cross_entropy", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    """(input - label) ** 2 elementwise: an elementwise_sub and a square."""
    helper = LayerHelper("square_error_cost", input=input)
    minus_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]}, attrs={"axis": -1})
    sq = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [sq]})
    return sq


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", input=input, name=name)
    return _single_out(helper, "log_loss",
                       {"Predicted": [input], "Labels": [label]},
                       {"epsilon": epsilon}, dtype=input.dtype, slot="Loss")


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss", input=input)
    residual = helper.create_variable_for_type_inference(input.dtype,
                                                         stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", input=x, name=name)
    return _single_out(helper, "kldiv_loss",
                       {"X": [x], "Target": [target]},
                       {"reduction": reduction}, dtype=x.dtype, slot="Loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    helper = LayerHelper("npair_loss", input=anchor)
    return _single_out(helper, "npair_loss",
                       {"Anchor": [anchor], "Positive": [positive],
                        "Labels": [labels]},
                       {"l2_reg": l2_reg}, dtype=anchor.dtype)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper("teacher_student_sigmoid_loss", input=input)
    return _single_out(helper, "teacher_student_sigmoid_loss",
                       {"X": [input], "Label": [label]},
                       {"soft_max_up_bound": soft_max_up_bound,
                        "soft_max_lower_bound": soft_max_lower_bound},
                       dtype=input.dtype, slot="Y")


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss", input=x)
    diff = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", input=input, name=name)
    return _single_out(helper, "bpr_loss",
                       {"X": [input], "Label": [label]}, dtype=input.dtype,
                       slot="Y")


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", input=left, name=name)
    return _single_out(helper, "rank_loss",
                       {"Label": [label], "Left": [left], "Right": [right]},
                       dtype=left.dtype)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", input=left, name=name)
    act = helper.create_variable_for_type_inference(left.dtype,
                                                    stop_gradient=True)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": margin})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |input * onehot(label)| / (|input| + |onehot|) per sample,
    averaged: one_hot, reductions and the Variable operators."""
    label = one_hot(label, depth=input.shape[-1])
    reduce_dim = list(range(1, len(input.shape)))
    inse = reduce_sum(input * label, dim=reduce_dim)
    dice_denominator = reduce_sum(input, dim=reduce_dim) + \
        reduce_sum(label, dim=reduce_dim)
    dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
    return reduce_mean(dice_score)


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", input=input, name=name)
    return _single_out(helper, "hinge_loss",
                       {"Logits": [input], "Labels": [label]},
                       dtype=input.dtype, slot="Loss")


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    if isinstance(x, Variable):
        x = [x]
    helper = LayerHelper("stack", input=x)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack", input=x)
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", input=x, name=name)
    return _single_out(helper, "expand", {"X": [x]},
                       {"expand_times": list(expand_times)}, dtype=x.dtype)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", input=x, name=name)
    return _single_out(helper, "mul", {"X": [x], "Y": [y]},
                       {"x_num_col_dims": x_num_col_dims,
                        "y_num_col_dims": y_num_col_dims}, dtype=x.dtype)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", input=input, name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def shape(input):
    helper = LayerHelper("shape", input=input)
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", input=x, name=name)
    return _single_out(helper, "pad", {"X": [x]},
                       {"paddings": list(paddings),
                        "pad_value": float(pad_value)}, dtype=x.dtype)


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", input=input, name=name)
    return _single_out(helper, "pad2d", {"X": [input]},
                       {"paddings": list(paddings), "mode": mode,
                        "pad_value": float(pad_value),
                        "data_format": data_format}, dtype=input.dtype)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", input=x, name=name)
    return _single_out(helper, "pad_constant_like", {"X": [x], "Y": [y]},
                       {"pad_value": float(pad_value)}, dtype=y.dtype)


def gather(input, index):
    helper = LayerHelper("gather", input=input)
    return _single_out(helper, "gather", {"X": [input], "Index": [index]},
                       dtype=input.dtype)


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", input=input, name=name)
    return _single_out(helper, "scatter",
                       {"X": [input], "Ids": [index], "Updates": [updates]},
                       {"overwrite": overwrite}, dtype=input.dtype)


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    seed_out = helper.create_variable_for_type_inference("int64",
                                                         stop_gradient=True)
    helper.append_op(type="random_crop", inputs={"X": [x]},
                     outputs={"Out": [out], "SeedOut": [seed_out]},
                     attrs={"shape": list(shape),
                            "seed": seed if seed is not None else 0})
    return out


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", input=x, name=name)
    if isinstance(shape, Variable):
        raise NotImplementedError("a crop shape held in a Variable is not "
                                  "supported: pass a list")
    offsets = offsets or [0] * len(x.shape)
    return _single_out(helper, "crop", {"X": [x]},
                       {"shape": list(shape), "offsets": list(offsets)},
                       dtype=x.dtype)


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth", input=x, name=name)
    return _single_out(helper, "space_to_depth", {"X": [x]},
                       {"blocksize": blocksize}, dtype=x.dtype)


def shuffle_channel(x, group, name=None):
    helper = LayerHelper("shuffle_channel", input=x, name=name)
    return _single_out(helper, "shuffle_channel", {"X": [x]},
                       {"group": group}, dtype=x.dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like", input=input)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx, "min": min,
                            "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean, "std": std,
                            "seed": seed, "dtype": dtype})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like", input=input)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean, "std": std,
                            "seed": seed, "dtype": dtype,
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """One int64 id a row of probabilities ``x``; min, max and dtype are
    taken and not used, as in the JAX package."""
    helper = LayerHelper("sampling_id", input=x)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"seed": seed})
    return out


def sum(x):
    if isinstance(x, Variable):
        x = [x]
    helper = LayerHelper("sum", input=x)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="sum", inputs={"X": x}, outputs={"Out": [out]})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", input=inputs)
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse", input=x)
    axis = [axis] if isinstance(axis, int) else list(axis)
    return _single_out(helper, "reverse", {"X": [x]}, {"axis": axis},
                       dtype=x.dtype)


def merge_selected_rows(x, name=None):
    """A sparse gradient is held as its [n, dim] values (with the ids in
    ``@ROWS``), one row an id as looked up, and the optimizers add
    repeated rows themselves: x itself, no op (the JAX package's layer)."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    """x itself, no op (the JAX package's layer; see merge_selected_rows)."""
    return x


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True, act=None,
                     name=None):
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is None")
        output_size = [output_size] * 2 if isinstance(output_size, int) \
            else list(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1) //
            dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1) //
            dilation[1] + 1]
    else:
        filter_size = [filter_size] * 2 if isinstance(filter_size, int) \
            else list(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper("conv3d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = [filter_size] * 3 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 3 if isinstance(dilation, int) else list(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True):
    helper = LayerHelper("pool3d", input=input, name=name)
    pool_size = [pool_size] * 3 if isinstance(pool_size, int) \
        else list(pool_size)
    pool_stride = [pool_stride] * 3 if isinstance(pool_stride, int) \
        else list(pool_stride)
    pool_padding = [pool_padding] * 3 if isinstance(pool_padding, int) \
        else list(pool_padding)
    return _single_out(helper, "pool3d", {"X": [input]},
                       {"pooling_type": pool_type, "ksize": pool_size,
                        "strides": pool_stride, "paddings": pool_padding,
                        "global_pooling": global_pooling,
                        "ceil_mode": ceil_mode, "exclusive": exclusive})


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    channel_num = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        s = helper.create_parameter(attr=helper.param_attr,
                                    shape=[channel_num], dtype="float32",
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[channel_num],
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference("float32",
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(out)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    helper = LayerHelper("data_norm", input=input, act=act, name=name)
    dtype = helper.input_dtype()
    c = input.shape[1]
    batch_size = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(1e4)), shape=[c], dtype=dtype)
    batch_sum = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(0.0)), shape=[c], dtype=dtype)
    batch_square_sum = helper.create_parameter(
        attr=ParamAttr(initializer=Constant(1e4)), shape=[c], dtype=dtype)
    means = helper.create_variable_for_type_inference(dtype)
    scales = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="data_norm",
                     inputs={"X": [input], "BatchSize": [batch_size],
                             "BatchSum": [batch_sum],
                             "BatchSquareSum": [batch_square_sum]},
                     outputs={"Y": [out], "Means": [means],
                              "Scales": [scales]},
                     attrs={"epsilon": epsilon})
    return helper.append_activation(out)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", input=x, name=name)
    out = _single_out(helper, "affine_channel",
                      {"X": [x], "Scale": [scale], "Bias": [bias]},
                      {"data_layout": data_layout}, dtype=x.dtype)
    return helper.append_activation(out) if act else out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", input=input, name=name)
    mid = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    helper = LayerHelper("im2sequence", input=input, name=name)
    filter_size = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    padding = [padding] * 4 if isinstance(padding, int) else list(padding)
    if len(padding) == 2:
        padding = padding * 2
    return _single_out(helper, "im2sequence", {"X": [input]},
                       {"kernels": filter_size, "strides": stride,
                        "paddings": padding}, dtype=input.dtype)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    helper = LayerHelper("image_resize", input=input, name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    op_type = "bilinear_interp" if resample.upper() == "BILINEAR" \
        else "nearest_interp"
    return _single_out(helper, op_type, {"X": [input]},
                       {"out_h": int(out_shape[0]), "out_w": int(out_shape[1])},
                       dtype=input.dtype)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST")


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", input=x,
                         param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    dtype = helper.input_dtype()
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[1], y.shape[1]],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[1, size],
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", input=x, name=name)
    return _single_out(helper, "grid_sampler", {"X": [x], "Grid": [grid]},
                       dtype=x.dtype, slot="Output")


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", input=input, param_attr=param_attr,
                         act=act)
    dtype = helper.input_dtype()
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[future_context_size + 1,
                                       input.shape[-1]],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Weight / sigma_max(Weight) via power iteration (reference:
    layers/nn.py:3402 + spectral_norm_op.cc). U [H] and V [W] are persistable
    power-iteration state params with stop_gradient, H = weight.shape[dim],
    W = prod(other dims), written back by the op's UOut and VOut."""
    helper = LayerHelper("spectral_norm", input=weight, name=name)
    dtype = weight.dtype
    input_shape = weight.shape
    h = int(input_shape[dim])
    w = int(np.prod([abs(d) for d in input_shape])) // h
    u = helper.create_parameter(attr=None, shape=[h], dtype=dtype,
                                default_initializer=Normal(0., 1.))
    u.stop_gradient = True
    v = helper.create_parameter(attr=None, shape=[w], dtype=dtype,
                                default_initializer=Normal(0., 1.))
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="spectral_norm",
        inputs={"Weight": [weight], "U": [u], "V": [v]},
        # U/V written back: the power iteration goes on across steps
        outputs={"Out": [out], "UOut": [u], "VOut": [v]},
        attrs={"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Adaptive 2D pooling to a target output size (reference
    adaptive_pool2d -> pool2d op with adaptive=True); require_index builds
    max_pool2d_with_index and returns (out, mask)."""
    if require_index:
        helper = LayerHelper("max_pool2d_with_index", input=input, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        mask = helper.create_variable_for_type_inference("int32")
        helper.append_op(type="max_pool2d_with_index",
                         inputs={"X": [input]},
                         outputs={"Out": [out], "Mask": [mask]},
                         attrs={"ksize": list(pool_size)
                                if isinstance(pool_size, (list, tuple))
                                else [pool_size, pool_size],
                                "adaptive": True, "pooling_type": "max"})
        return out, mask
    helper = LayerHelper("adaptive_pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ks = list(pool_size) if isinstance(pool_size, (list, tuple)) else \
        [pool_size, pool_size]
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": ks,
                            "adaptive": True})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        raise NotImplementedError(
            "adaptive_pool3d(require_index=True): 3D index pooling has no "
            "reference-model user; file shapes via adaptive_pool2d")
    helper = LayerHelper("adaptive_pool3d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ks = list(pool_size) if isinstance(pool_size, (list, tuple)) else \
        [pool_size] * 3
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": ks,
                            "adaptive": True})
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the SHORT side equals out_short_len, keeping aspect
    (reference layers/nn.py image_resize_short)."""
    in_shape = input.shape
    if len(in_shape) != 4:
        raise ValueError("image_resize_short expects NCHW input")
    h, w = in_shape[2], in_shape[3]
    short = min(h, w)
    out_shape = [int(round(h * out_short_len / short)),
                 int(round(w * out_short_len / short))]
    return image_resize(input, out_shape=out_shape, resample=resample)


def similarity_focus(input, axis, indexes, name=None):
    helper = LayerHelper("similarity_focus", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="similarity_focus", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "indexes": list(indexes)})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """Hash int id rows into hash_size buckets, num_hash ways: int64 [B,
    num_hash, 1] (reference hash_op.cc; the JAX package's mixer, not
    xxHash: ROADMAP Queue 3)."""
    helper = LayerHelper("hash", input=input, name=name)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="hash", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"mod_by": hash_size, "num_hash": num_hash})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk (NER span) evaluation over tag ids [B, T] or [B, T, 1]
    (reference chunk_eval_op): (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks). No Length input, as in the JAX
    package: a padded tail is scored as tags (ROADMAP Queue 3)."""
    helper = LayerHelper("chunk_eval", input=input)

    def out(dtype):
        return helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    precision, recall, f1 = out("float32"), out("float32"), out("float32")
    num_infer, num_label, num_correct = out("int64"), out("int64"), \
        out("int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1], "NumInferChunks": [num_infer],
                 "NumLabelChunks": [num_label],
                 "NumCorrectChunks": [num_correct]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, num_infer, num_label, num_correct


def fsp_matrix(x, y):
    """Flow-of-solution-procedure (Gram) matrix between two feature maps
    (reference fsp_op.cc, used for distillation)."""
    helper = LayerHelper("fsp_matrix", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fsp", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Tree-based convolution (reference tree_conv_op.cc / TBCNN)."""
    helper = LayerHelper("tree_conv", input=nodes_vector,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = nodes_vector.dtype
    feature_size = nodes_vector.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[feature_size, 3, output_size,
                                       num_filters],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="tree_conv",
                     inputs={"NodesVector": [nodes_vector],
                             "EdgeSet": [edge_set], "Filter": [w]},
                     outputs={"Out": [out]},
                     attrs={"max_depth": max_depth})
    if helper.bias_attr:
        out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out) if act else out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Softmax CE over the true classes plus a sampled subset of the vocab
    (reference sample_logits_op.cc + softmax_with_cross_entropy). Output
    loss [N, 1]."""
    helper = LayerHelper("sampled_softmax_with_cross_entropy", input=logits)
    loss = helper.create_variable_for_type_inference("float32")
    inputs = {"Logits": [logits], "Labels": [label]}
    if use_customized_samples:
        inputs["CustomizedSamples"] = [customized_samples]
        inputs["CustomizedProbabilities"] = [customized_probabilities]
    helper.append_op(type="sampled_softmax_with_cross_entropy",
                     inputs=inputs, outputs={"Loss": [loss]},
                     attrs={"num_samples": num_samples,
                            "num_true": num_true,
                            "remove_accidental_hits": remove_accidental_hits,
                            "use_customized_samples": use_customized_samples,
                            "seed": seed})
    return loss


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid over a complete binary tree (reference
    hierarchical_sigmoid_op.cc). Returns cost [N, 1]."""
    helper = LayerHelper("hsigmoid", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    if is_custom and (path_table is None or path_code is None):
        raise ValueError("is_custom requires path_table and path_code")
    # custom trees address any node id < num_classes (reference sizes W by
    # num_classes); default complete tree has num_classes-1 internal nodes
    n_nodes = num_classes if is_custom else num_classes - 1
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[n_nodes, input.shape[-1]],
                                dtype=dtype)
    b = helper.create_parameter(attr=helper.bias_attr, shape=[n_nodes, 1],
                                dtype=dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input], "Label": [label], "W": [w], "Bias": [b]}
    if is_custom:
        inputs["PathTable"] = [path_table]
        inputs["PathCode"] = [path_code]
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [cost]},
                     attrs={"num_classes": num_classes,
                            "is_custom": is_custom})
    return cost


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 3D convolution (reference conv3d_transpose ->
    conv3d_transpose_op)."""
    helper = LayerHelper("conv3d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    c_in = input.shape[1]
    g = groups or 1
    if filter_size is None:
        raise ValueError("conv3d_transpose requires filter_size")
    fs = list(filter_size) if isinstance(filter_size, (list, tuple)) else \
        [filter_size] * 3
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[c_in, num_filters // g] + fs,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": [stride] * 3
                            if not isinstance(stride, (list, tuple))
                            else list(stride),
                            "paddings": [padding] * 3
                            if not isinstance(padding, (list, tuple))
                            else list(padding),
                            "dilations": [dilation] * 3
                            if not isinstance(dilation, (list, tuple))
                            else list(dilation),
                            "groups": g,
                            "output_size": list(output_size)
                            if output_size else []})
    if helper.bias_attr:
        out = helper.append_bias_op(out, dim_start=1)
    return helper.append_activation(out) if act else out


def affine_grid(theta, out_shape, name=None):
    """Affine sampling grid from 2x3 theta (reference affine_grid_op)."""
    helper = LayerHelper("affine_grid", input=theta, name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs = {"Theta": [theta]}
    attrs = {}
    if isinstance(out_shape, Variable):
        inputs["OutputShape"] = [out_shape]
    else:
        attrs["output_shape"] = list(out_shape)
    helper.append_op(type="affine_grid", inputs=inputs,
                     outputs={"Output": [out]}, attrs=attrs)
    return out


def lod_reset(x, y=None, target_lod=None):
    """Re-attach sequence structure (reference lod_reset_op). In the padded
    layout this re-binds the length vector."""
    helper = LayerHelper("lod_reset", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = list(target_lod)
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 length=None):
    """LSTM over a padded [B, T, 4H] pre-projected input (reference:
    layers/nn.py dynamic_lstm over LoD): the ``dynamic_lstm`` op, which
    reads the input's lengths."""
    from .sequence import get_sequence_length, attach_sequence_length
    helper = LayerHelper("dynamic_lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    length = get_sequence_length(input, length)
    hidden_dim = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_dim, 4 * hidden_dim],
                                dtype=dtype)
    bias_size = 4 * hidden_dim if not use_peepholes else 7 * hidden_dim
    b = helper.create_parameter(attr=helper.bias_attr, shape=[1, bias_size],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    if length is not None:
        attach_sequence_length(hidden, length)
        attach_sequence_length(cell, length)
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  cell_clip=None, proj_clip=None, length=None):
    """Projected LSTM over a padded [B, T, 4H] input (reference:
    layers/nn.py dynamic_lstmp, lstmp_op.h: the recurrence runs over the
    projection). cell_clip and proj_clip reach the op, which ignores
    them."""
    from .sequence import get_sequence_length, attach_sequence_length
    helper = LayerHelper("dynamic_lstmp", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    length = get_sequence_length(input, length)
    hidden_dim = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[proj_size, 4 * hidden_dim], dtype=dtype)
    w_proj = helper.create_parameter(attr=helper.param_attr,
                                     shape=[hidden_dim, proj_size],
                                     dtype=dtype)
    bias_size = 4 * hidden_dim if not use_peepholes else 7 * hidden_dim
    b = helper.create_parameter(attr=helper.bias_attr, shape=[1, bias_size],
                                dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "ProjWeight": [w_proj],
              "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="lstmp", inputs=inputs,
                     outputs={"Projection": [proj], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation,
                            "cell_clip": cell_clip, "proj_clip": proj_clip})
    if length is not None:
        attach_sequence_length(proj, length)
        attach_sequence_length(cell, length)
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None, length=None):
    """GRU over a padded [B, T, 3H] pre-projected input (reference:
    layers/nn.py dynamic_gru over LoD)."""
    from .sequence import get_sequence_length, attach_sequence_length
    helper = LayerHelper("dynamic_gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    length = get_sequence_length(input, length)
    dtype = helper.input_dtype()
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, 3 * size], dtype=dtype)
    b = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * size],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="dynamic_gru", inputs=inputs,
                     outputs={"Hidden": [hidden]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "origin_mode": origin_mode,
                            "activation": candidate_activation})
    if length is not None:
        attach_sequence_length(hidden, length)
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", origin_mode=False):
    """One GRU step (reference: layers/nn.py gru_unit). Returns (hidden,
    reset_hidden_prev, gate). origin_mode is taken and dropped, as in the
    JAX package: the op always interpolates u h_prev + (1 - u) c."""
    helper = LayerHelper("gru_unit", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    size = size // 3
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, 3 * size], dtype=dtype)
    b = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * size],
                                dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Gate": [gate],
                              "ResetHiddenPrev": [reset_hidden],
                              "Hidden": [updated]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return updated, reset_hidden, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (reference: layers/nn.py lstm_unit): an fc of [x_t,
    hidden_t_prev] to 4H, then the ``lstm_unit`` op. Returns (h, c)."""
    helper = LayerHelper("lstm_unit", input=x_t, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = helper.input_dtype()
    size = cell_t_prev.shape[-1]
    concat = fc(input=[x_t, hidden_t_prev], size=4 * size,
                param_attr=param_attr, bias_attr=bias_attr,
                num_flatten_dims=1)
    c = helper.create_variable_for_type_inference(dtype)
    h = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [concat], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer, optionally bidirectional LSTM over a [T, B, I] input
    (reference: layers/nn.py lstm, the cuDNN path): the ``cudnn_lstm`` op
    over one packed weight. Returns (out, last_h, last_c)."""
    helper = LayerHelper("lstm", input=input, name=name)
    dtype = input.dtype
    num_dirs = 2 if is_bidirec else 1
    input_size = input.shape[-1]
    w_size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size * num_dirs
        w_size += num_dirs * (4 * hidden_size * (in_sz + hidden_size) +
                              8 * hidden_size)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[w_size], dtype=dtype,
        default_initializer=default_initializer)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="cudnn_lstm",
        inputs={"Input": [input], "InitH": [init_h], "InitC": [init_c],
                "W": [w]},
        outputs={"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"hidden_size": hidden_size, "num_layers": num_layers,
               "is_bidirec": is_bidirec, "dropout_prob": dropout_prob,
               "is_test": is_test, "seed": seed})
    return out, last_h, last_c


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF log-likelihood over padded [B, T, num_tags] emissions (reference:
    layers/nn.py linear_chain_crf / linear_chain_crf_op.h; transition rows
    [0] start, [1] stop, [2:] pairwise), over the input's lengths."""
    from .sequence import get_sequence_length
    helper = LayerHelper("linear_chain_crf", input=input,
                         param_attr=param_attr)
    length = get_sequence_length(input, length)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(attr=helper.param_attr,
                                         shape=[num_tags + 2, num_tags],
                                         dtype=helper.input_dtype())
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype,
                                                      stop_gradient=True)
    e_exps = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    t_exps = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                              "EmissionExps": [e_exps],
                              "TransitionExps": [t_exps]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decoding over the input's lengths (reference:
    crf_decoding_op.h): the path, or with ``label`` its 0/1 agreement."""
    from .sequence import get_sequence_length
    helper = LayerHelper("crf_decoding", input=input, param_attr=param_attr)
    length = get_sequence_length(input, length)
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[input.shape[-1] + 2, input.shape[-1]],
        dtype=helper.input_dtype())
    path = helper.create_variable_for_type_inference("int64",
                                                     stop_gradient=True)
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None, sampler="uniform",
        custom_dist=None, seed=12345, is_sparse=False):
    """Noise-contrastive estimation against uniform noise (reference:
    nce_op.h). As in the JAX package, sample_weight, sampler, custom_dist
    and is_sparse are taken and not passed on (ROADMAP Queue 3)."""
    helper = LayerHelper("nce", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[num_total_classes], dtype=dtype,
                                   is_bias=True)
    cost = helper.create_variable_for_type_inference(dtype)
    s_logits = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    s_labels = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op(type="nce",
                     inputs={"Input": [input], "Label": [label],
                             "Weight": [w], "Bias": [bias]},
                     outputs={"Cost": [cost], "SampleLogits": [s_logits],
                              "SampleLabels": [s_labels]},
                     attrs={"num_neg_samples": num_neg_samples,
                            "seed": seed or 12345,
                            "num_total_classes": num_total_classes})
    return cost


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam-search step over a source's beam_size rows (reference:
    beam_search_op). As in the JAX package, ``ids`` is not passed to the
    op (ROADMAP Queue 3)."""
    helper = LayerHelper("beam_search", input=scores, name=name)
    selected_ids = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    selected_scores = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    parent_idx = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    # downstream layers (embedding, fc in decode loops) need static ranks
    selected_ids.shape = (-1, 1)
    selected_scores.shape = (-1, 1)
    parent_idx.shape = (-1,)
    helper.append_op(type="beam_search",
                     inputs={"pre_ids": [pre_ids],
                             "pre_scores": [pre_scores],
                             "scores": [scores]},
                     outputs={"selected_ids": [selected_ids],
                              "selected_scores": [selected_scores],
                              "parent_idx": [parent_idx]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, parent_idx, scores, beam_size=None, end_id=1,
                       name=None):
    """The hypotheses backtracked from the stacked steps' ids and parents
    (reference: beam_search_decode_op)."""
    helper = LayerHelper("beam_search_decode", input=ids, name=name)
    sent_ids = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    sent_scores = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": [ids], "ParentIdx": [parent_idx],
                             "Scores": [scores]},
                     outputs={"SentenceIds": [sent_ids],
                              "SentenceScores": [sent_scores]},
                     attrs={"beam_size": beam_size or 0, "end_id": end_id})
    return sent_ids, sent_scores


def switch_moe(input, num_experts, expert_hidden, capacity_factor=2.0,
               param_attr=None, name=None, strategy=None):
    """The JAX package's switch-transformer FFN waits for ROADMAP Queue 1
    item 7 (expert parallelism)."""
    raise NotImplementedError("switch_moe waits for ROADMAP Queue 1 item 7 "
                              "(multi-device)")


def warpctc(input, label, blank=0, norm_by_times=False, use_cudnn=False,
            input_length=None, label_length=None):
    """CTC loss (reference: layers/nn.py warpctc / warpctc_op.cc). Dense
    layout: input [B, T, C] logits + input_length, label [B, L] +
    label_length; Loss [B, 1]."""
    helper = LayerHelper("warpctc", input=input)
    loss_out = helper.create_variable_for_type_inference("float32")
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    helper.append_op(type="warpctc", inputs=ins, outputs={"Loss": [loss_out]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss_out


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """top_k(1) + squeeze + ctc_align's merge and de-blank (reference:
    layers/nn.py ctc_greedy_decoder). Returns (decoded [B, T] 0-padded,
    length [B])."""
    helper = LayerHelper("ctc_greedy_decoder", input=input, name=name)
    topk_val = helper.create_variable_for_type_inference(input.dtype)
    topk_idx = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_val], "Indices": [topk_idx]},
                     attrs={"k": 1})
    idx_flat = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op(type="squeeze", inputs={"X": [topk_idx]},
                     outputs={"Out": [idx_flat]}, attrs={"axes": [-1]})
    out = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    out_len = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    ins = {"Input": [idx_flat]}
    if input_length is not None:
        ins["Length"] = [input_length]
    helper.append_op(type="ctc_align", inputs=ins,
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out, out_len


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance (reference: layers/nn.py edit_distance):
    (distances [B, 1], sequence count)."""
    helper = LayerHelper("edit_distance", input=input)
    out = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    seq_num = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    helper.append_op(type="edit_distance", inputs=ins,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized,
                            "ignored_tokens": [int(t) for t in
                                               (ignored_tokens or [])]})
    return out, seq_num


def mean_iou(input, label, num_classes):
    """Mean intersection over union (reference: layers/nn.py mean_iou):
    (mean IoU, wrong and correct predictions by class)."""
    helper = LayerHelper("mean_iou", input=input)
    iou = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    wrong = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    correct = helper.create_variable_for_type_inference("int32",
                                                        stop_gradient=True)
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [iou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return iou, wrong, correct


def unpool(input, indices, unpool_type="max", ksize=None, strides=None,
           paddings=None, output_size=None, name=None):
    """Max unpooling from recorded indices (reference: unpool_op.cc);
    output_size is not passed to the op, as in the JAX package."""
    helper = LayerHelper("unpool", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unpool",
                     inputs={"X": [input], "Indices": [indices]},
                     outputs={"Out": [out]},
                     attrs={"unpooling_type": unpool_type,
                            "ksize": list(ksize or [2, 2]),
                            "strides": list(strides or [2, 2]),
                            "paddings": list(paddings or [0, 0])})
    return out


def spp(input, pyramid_height=3, pool_type="max", name=None):
    """Spatial pyramid pooling (reference: spp_op.cc)."""
    helper = LayerHelper("spp", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="spp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


class PyFuncRegistry(object):
    """Process-local registry of py_func callables (reference py_func_op.cc
    PyFuncRegistry: callables cannot serialize, so programs carry ids)."""
    _funcs = []

    @classmethod
    def register(cls, fn):
        cls._funcs.append(fn)
        return len(cls._funcs) - 1

    @classmethod
    def get(cls, idx):
        return cls._funcs[idx]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Call a Python function as an op (reference: layers/nn.py py_func,
    operators/py_func_op.cc). ``func`` receives the inputs as numpy arrays
    on the host (the ``py_func`` host op, fluid/host_ops.py) and its
    results go back to the device.

    ``out`` variables must be created beforehand (create_variable): their
    shapes and dtypes are the caller's contract, as in the reference. With
    ``backward_func``, the grad op calls it with (inputs, outputs, output
    grads) less ``skip_vars_in_backward_input``, and it returns one grad
    per input (None allowed)."""
    helper = LayerHelper("py_func")
    xs = [x] if isinstance(x, Variable) else list(x or [])
    outs = [out] if isinstance(out, Variable) else list(out)
    skip = skip_vars_in_backward_input or []
    skip_names = [v.name if isinstance(v, Variable) else str(v) for v in skip]
    fid = PyFuncRegistry.register(func)
    bid = PyFuncRegistry.register(backward_func) if backward_func else -1
    helper.append_op(type="py_func",
                     inputs={"X": xs},
                     outputs={"Out": outs},
                     attrs={"func_id": fid, "backward_func_id": bid,
                            "skip_vars_in_backward_input": skip_names})
    return outs if len(outs) > 1 else outs[0]
