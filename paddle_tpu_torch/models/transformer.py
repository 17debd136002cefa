"""Transformer for machine translation — the flagship model.

The port's counterpart of ``paddle_tpu/models/transformer.py``: the same
``build()`` signature, the same ops and the same parameter names
(``enc.0.attn.q.w``, ``src_emb``, ``proj.w``, ...), so a Program built here
is op-for-op identical to the JAX package's and takes its weights. Every
attention instance is one ``fused_attention`` op on [B, T, H, Dh], which
runs the one-pass or flash CUDA kernel on the card, forward and backward.
``serving_programs`` and ``training_programs`` build the two paths.
Sharding (``strategy``) is not ported yet.
"""
import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import ParamAttr
from paddle_tpu_torch.fluid.layer_helper import LayerHelper

# the flagship configuration (bench.py's CFG); its long-sequence config is
# the same at seq_len=4096
FLAGSHIP_CFG = dict(src_vocab=8192, tgt_vocab=8192, seq_len=256, n_layer=4,
                    n_head=8, d_model=512, d_ff=2048, dropout_rate=0.1,
                    dtype="bfloat16")


def _fc(x, size, name, act=None, num_flatten_dims=2):
    return fluid.layers.fc(input=x, size=size, act=act,
                           num_flatten_dims=num_flatten_dims,
                           param_attr=ParamAttr(name=name + ".w"),
                           bias_attr=ParamAttr(name=name + ".b"))


def _causal_bias(seq_len, name):
    helper = LayerHelper("causal_mask", name=name)
    out = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    helper.append_op(type="causal_mask", outputs={"Out": [out]},
                     attrs={"seq_len": seq_len, "dtype": "float32"})
    return out


def multi_head_attention(q_in, kv_in, d_model, n_head, dropout_rate, name,
                         attn_bias=None, causal=False, is_test=False,
                         use_fused=True):
    """Scaled dot-product attention with per-head split via reshape (and
    transpose on the unfused path). With use_fused and no explicit bias, the
    score/softmax/context chain is one fused_attention op; attention-weight
    dropout applies only on the unfused path."""
    d_head = d_model // n_head
    q = _fc(q_in, d_model, name + ".q")
    k = _fc(kv_in, d_model, name + ".k")
    v = _fc(kv_in, d_model, name + ".v")

    def split_heads(x, transpose=True):
        # [B, T, D] -> [B, T, H, Dh] (-> [B, H, T, Dh] when transpose)
        x = fluid.layers.reshape(x, [0, 0, n_head, d_head])
        return fluid.layers.transpose(x, [0, 2, 1, 3]) if transpose else x

    if use_fused and attn_bias is None:
        q = split_heads(q, transpose=False)
        k = split_heads(k, transpose=False)
        v = split_heads(v, transpose=False)
        helper = LayerHelper("fused_attention", name=name + ".fused")
        ctx = helper.create_variable_for_type_inference(q.dtype)
        helper.append_op(type="fused_attention",
                         inputs={"Q": [q], "K": [k], "V": [v]},
                         outputs={"Out": [ctx]},
                         attrs={"causal": causal, "scale": -1.0,
                                "layout": "bthd",
                                "sequence_parallel": False})
    else:
        q = split_heads(q)
        k = split_heads(k)
        v = split_heads(v)
        scaled_q = fluid.layers.scale(q, scale=d_head ** -0.5)
        scores = fluid.layers.matmul(scaled_q, k, transpose_y=True)
        if attn_bias is not None:
            scores = fluid.layers.elementwise_add(scores, attn_bias)
        weights = fluid.layers.softmax(scores)
        if dropout_rate:
            weights = fluid.layers.dropout(
                weights, dropout_prob=dropout_rate, is_test=is_test,
                dropout_implementation="upscale_in_train")
        ctx = fluid.layers.matmul(weights, v)      # [B, H, T, Dh]
        ctx = fluid.layers.transpose(ctx, [0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, [0, 0, d_model])
    return _fc(ctx, d_model, name + ".out")


def ffn(x, d_model, d_ff, dropout_rate, name, is_test=False):
    h = _fc(x, d_ff, name + ".fc1", act="relu")
    if dropout_rate:
        h = fluid.layers.dropout(h, dropout_prob=dropout_rate,
                                 is_test=is_test,
                                 dropout_implementation="upscale_in_train")
    return _fc(h, d_model, name + ".fc2")


def _pre_post(x, residual, dropout_rate, name, is_test=False):
    """post-process: residual add + layer_norm."""
    if dropout_rate:
        x = fluid.layers.dropout(x, dropout_prob=dropout_rate,
                                 is_test=is_test,
                                 dropout_implementation="upscale_in_train")
    out = fluid.layers.elementwise_add(x, residual)
    return fluid.layers.layer_norm(
        out, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + ".ln_scale"),
        bias_attr=ParamAttr(name=name + ".ln_bias"))


def encoder_layer(x, d_model, n_head, d_ff, dropout_rate, name,
                  is_test=False, use_fused=True):
    attn = multi_head_attention(x, x, d_model, n_head, dropout_rate,
                                name + ".attn", is_test=is_test,
                                use_fused=use_fused)
    x = _pre_post(attn, x, dropout_rate, name + ".attn_post", is_test)
    f = ffn(x, d_model, d_ff, dropout_rate, name + ".ffn", is_test)
    return _pre_post(f, x, dropout_rate, name + ".ffn_post", is_test)


def decoder_layer(x, enc_out, causal_bias, d_model, n_head, d_ff,
                  dropout_rate, name, is_test=False, use_fused=True):
    self_attn = multi_head_attention(
        x, x, d_model, n_head, dropout_rate, name + ".self",
        attn_bias=None if use_fused else causal_bias, causal=True,
        is_test=is_test, use_fused=use_fused)
    x = _pre_post(self_attn, x, dropout_rate, name + ".self_post", is_test)
    cross = multi_head_attention(x, enc_out, d_model, n_head, dropout_rate,
                                 name + ".cross", is_test=is_test,
                                 use_fused=use_fused)
    x = _pre_post(cross, x, dropout_rate, name + ".cross_post", is_test)
    f = ffn(x, d_model, d_ff, dropout_rate, name + ".ffn", is_test)
    return _pre_post(f, x, dropout_rate, name + ".ffn_post", is_test)


def _embed(ids, vocab, d_model, name, dtype="float32"):
    emb = fluid.layers.embedding(
        ids, size=[vocab, d_model], dtype=dtype,
        param_attr=ParamAttr(name=name,
                             initializer=fluid.initializer.Normal(
                                 0.0, d_model ** -0.5)))
    return fluid.layers.add_position_encoding(
        fluid.layers.scale(emb, scale=d_model ** 0.5), alpha=1.0, beta=1.0)


def build(src_vocab=4000, tgt_vocab=4000, seq_len=64, n_layer=2, n_head=8,
          d_model=256, d_ff=1024, dropout_rate=0.1, strategy=None,
          is_test=False, label_smooth_eps=0.0, use_fused_attention=True,
          dtype="float32"):
    """Build the full MT model on the default main program.

    Returns (feed names, avg_loss). Feeds: src_ids [B,S] int64, tgt_ids [B,S]
    int64 (decoder input), labels [B,S,1] int64. The logits are the input of
    the loss op (``logits_of(avg_loss)``).
    """
    if strategy is not None:
        raise NotImplementedError("sharding strategies are not ported yet; "
                                  "build with strategy=None")
    src = fluid.layers.data(name="src_ids", shape=[seq_len], dtype="int64")
    tgt = fluid.layers.data(name="tgt_ids", shape=[seq_len], dtype="int64")
    label = fluid.layers.data(name="labels", shape=[seq_len, 1],
                              dtype="int64")

    enc = _embed(src, src_vocab, d_model, "src_emb", dtype=dtype)
    if dropout_rate:
        enc = fluid.layers.dropout(enc, dropout_prob=dropout_rate,
                                   is_test=is_test,
                                   dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        enc = encoder_layer(enc, d_model, n_head, d_ff, dropout_rate,
                            "enc.%d" % i, is_test,
                            use_fused=use_fused_attention)

    causal = None if use_fused_attention else _causal_bias(seq_len, "causal")
    dec = _embed(tgt, tgt_vocab, d_model, "tgt_emb", dtype=dtype)
    if dropout_rate:
        dec = fluid.layers.dropout(dec, dropout_prob=dropout_rate,
                                   is_test=is_test,
                                   dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        dec = decoder_layer(dec, enc, causal, d_model, n_head, d_ff,
                            dropout_rate, "dec.%d" % i, is_test,
                            use_fused=use_fused_attention)

    logits = _fc(dec, tgt_vocab, "proj")
    if label_smooth_eps:
        # one_hot -> label_smooth -> soft-label cross-entropy, as the Fluid
        # Transformer's recipe (label_smooth_eps 0.1) trains
        onehot = fluid.layers.one_hot(label, depth=tgt_vocab)
        smoothed = fluid.layers.label_smooth(onehot, epsilon=label_smooth_eps)
        loss = fluid.layers.softmax_with_cross_entropy(logits, smoothed,
                                                       soft_label=True)
    else:
        loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    return ["src_ids", "tgt_ids", "labels"], avg_loss


def logits_of(avg_loss):
    """The logits variable of a program built by ``build``: the Logits input
    of its softmax_with_cross_entropy op."""
    block = avg_loss.block
    for op in block.ops:
        if op.type == "softmax_with_cross_entropy":
            return block.var(op.input("Logits")[0])
    raise ValueError("no softmax_with_cross_entropy op in the program")


def inference_program(main_program, avg_loss):
    """The serving program: ``main_program`` cloned for test and pruned to
    the logits from the two id feeds, as ``save_inference_model`` prunes."""
    logits = logits_of(avg_loss)
    return main_program.clone(for_test=True)._prune(
        ["src_ids", "tgt_ids"], [logits.name]), logits.name


def serving_programs(seed, **cfg):
    """Build the model with ``build``'s keywords ``cfg`` and is_test=True in
    fresh programs, the startup program seeded with ``seed``. Returns
    (serving program, startup program, logits name)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        _, avg_loss = build(is_test=True, **cfg)
    serve, logits = inference_program(main, avg_loss)
    return serve, startup, logits


def training_programs(seed, **cfg):
    """Build the model with ``build``'s keywords ``cfg`` in fresh programs,
    the startup program seeded with ``seed``, and append its training step
    as bench.py's training leg does (``Adam(1e-4).minimize``). Returns
    (main program, startup program, avg_loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        _, avg_loss = build(**cfg)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(avg_loss)
    return main, startup, avg_loss


def synthetic_batch(batch, seq_len, vocab, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, vocab, (batch, seq_len)).astype("int64")
    tgt = rng.randint(1, vocab, (batch, seq_len)).astype("int64")
    lab = rng.randint(1, vocab, (batch, seq_len, 1)).astype("int64")
    return {"src_ids": src, "tgt_ids": tgt, "labels": lab}
