"""Composite networks built from layers: the port's counterpart of
``paddle_tpu/fluid/nets.py`` (reference: python/paddle/fluid/nets.py).
Each function takes the JAX package's signature and emits the same ops.

``sequence_conv_pool`` needs ``sequence_conv`` and ``sequence_pool`` over
ragged sequences, which the port does not have yet (ROADMAP Queue 1 item
4); it raises.
"""
from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d, then pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A conv2d for each entry of ``conv_num_filter``, each optionally
    followed by batch_norm (carrying ``conv_act``) and dropout, then one
    pool2d: the VGG block."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def expand(v):
        return [v] * len(conv_num_filter) if not isinstance(
            v, (list, tuple)) else list(v)

    conv_padding = expand(conv_padding)
    conv_filter_size = expand(conv_filter_size)
    param_attr = expand(param_attr)
    conv_with_batchnorm = expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """sequence_conv, then sequence_pool: not ported yet."""
    raise NotImplementedError(
        "nets.sequence_conv_pool needs sequence_conv and sequence_pool over "
        "ragged sequences, which the port does not have yet (ROADMAP Queue "
        "1 item 4)")


def glu(input, dim=-1):
    """Gated linear unit: ``input`` split in two along ``dim``, a *
    sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, T, D] tensors: the
    heads split by reshape and transpose, softmax(Q K^T / sqrt(d)) V by
    matmul, the heads merged back."""
    if not (queries.shape[-1] % num_heads == 0):
        raise ValueError("queries' hidden size must be divisible by "
                         "num_heads")
    d_key = queries.shape[-1] // num_heads

    def split_heads(x):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(
            x, shape=[0, 0, num_heads, x.shape[-1] // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])

    q = split_heads(queries)
    k = split_heads(keys)
    v = split_heads(values)
    scaled_q = layers.scale(x=q, scale=d_key ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)
