"""Neural-network layers (the port's counterpart of
``paddle_tpu/fluid/layers/nn.py``): the layer functions the Transformer,
BERT, DeepFM and ResNet call, with the same signatures and the same ops,
slots and attrs."""
import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "topk",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "matmul", "transpose", "reshape", "flatten", "slice", "one_hot", "mean",
    "reduce_sum", "elementwise_add", "elementwise_sub", "scale", "square",
    "sigmoid", "add_position_encoding",
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
    the reference's ``depthwise_conv2d`` op, which is not ported yet."""
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


def _act_layer(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        return _single_out(helper, op_type, {"X": [x]}, dtype=x.dtype)
    layer.__name__ = op_type
    return layer


square = _act_layer("square")
sigmoid = _act_layer("sigmoid")


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """Sum over ``dim`` (an int or a list), or over everything when dim is
    None."""
    helper = LayerHelper("reduce_sum", input=input, name=name)
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"reduce_all": False, "dim": list(dims),
                 "keep_dim": keep_dim}
    return _single_out(helper, "reduce_sum", {"X": [input]}, attrs,
                       dtype=input.dtype)


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
