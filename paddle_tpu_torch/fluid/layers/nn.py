"""Neural-network layers (the port's counterpart of
``paddle_tpu/fluid/layers/nn.py``): the layer functions the Transformer,
BERT, DeepFM, ResNet, VGG, SE-ResNeXt and the MNIST MLP call, the
elementwise, logical, activation and reduction layers, clipping, label
smoothing, cos_sim and the global step counter of the learning-rate
schedules, the losses of the Fluid book and of ``fluid.layers`` (the
cross-entropy over probabilities, the squared error, log, Huber, KL,
n-pair, teacher-student, smooth L1, BPR, rank, margin-rank, dice and
hinge losses) and l2_normalize, with the same signatures and the same
ops, slots and attrs."""
import numpy as np

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
    if len(mul_results) != 1:
        raise NotImplementedError("fc over several inputs is not ported yet")
    pre_act = helper.append_bias_op(mul_results[0], dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Lookup table (reference: layers/nn.py embedding / lookup_table_op.cc)."""
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
