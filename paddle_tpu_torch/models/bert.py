"""BERT pretraining: an encoder-only Transformer with masked-LM and
next-sentence heads.

The port's counterpart of ``paddle_tpu/models/bert.py``: the same
``build()`` signature, ops and parameter names (``word_emb``,
``bert.0.attn.q.w``, ``mlm.transform.w``, ``pooler.w``, ...), so a Program
built here is op-for-op identical to the JAX package's and takes its
weights. The encoder blocks are the Transformer's (``encoder_layer``), so
each attention is one ``fused_attention`` op on the CUDA kernels.
``training_programs`` builds bench.py's BERT leg. Sharding (``strategy``)
and pipeline stages are not ported yet.
"""
import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import ParamAttr
from paddle_tpu_torch.models.transformer import encoder_layer, _fc

# bench.py's BERT_CFG, BERT_BATCH and BENCH_BERT_DTYPE's default: BERT-base
BERT_BASE_CFG = dict(vocab_size=30522, seq_len=128, n_layer=12, n_head=12,
                     d_model=768, d_ff=3072, dropout_rate=0.1,
                     dtype="bfloat16")
BERT_BASE_BATCH = 256


def build(vocab_size=30522, seq_len=128, n_layer=4, n_head=8, d_model=256,
          d_ff=1024, type_vocab=2, dropout_rate=0.1, strategy=None,
          is_test=False, max_predictions=20, dtype="float32",
          pipeline_stages=False):
    """Returns (feed names, total_loss). Feeds: input_ids [B,T], segment_ids
    [B,T], mlm_positions [B,P], mlm_labels [B,P,1], nsp_labels [B,1].
    dtype="bfloat16" puts the embeddings (and so every later matmul and
    parameter) in bf16; LayerNorm statistics and Adam moments stay f32."""
    if strategy is not None:
        raise NotImplementedError("sharding strategies are not ported yet; "
                                  "build with strategy=None")
    if pipeline_stages:
        raise NotImplementedError("pipeline stages are not ported yet; "
                                  "build with pipeline_stages=False")
    ids = fluid.layers.data(name="input_ids", shape=[seq_len], dtype="int64")
    seg = fluid.layers.data(name="segment_ids", shape=[seq_len],
                            dtype="int64")
    mlm_pos = fluid.layers.data(name="mlm_positions",
                                shape=[max_predictions], dtype="int64")
    mlm_label = fluid.layers.data(name="mlm_labels",
                                  shape=[max_predictions, 1], dtype="int64")
    nsp_label = fluid.layers.data(name="nsp_labels", shape=[1], dtype="int64")

    word_emb = fluid.layers.embedding(
        ids, size=[vocab_size, d_model], dtype=dtype,
        param_attr=ParamAttr(name="word_emb",
                             initializer=fluid.initializer.Normal(0.0, 0.02)))
    seg_emb = fluid.layers.embedding(
        seg, size=[type_vocab, d_model], dtype=dtype,
        param_attr=ParamAttr(name="seg_emb",
                             initializer=fluid.initializer.Normal(0.0, 0.02)))
    x = fluid.layers.elementwise_add(word_emb, seg_emb)
    x = fluid.layers.add_position_encoding(x, alpha=1.0, beta=1.0)
    x = fluid.layers.layer_norm(x, begin_norm_axis=2,
                                param_attr=ParamAttr(name="emb.ln_scale"),
                                bias_attr=ParamAttr(name="emb.ln_bias"))
    if dropout_rate:
        x = fluid.layers.dropout(x, dropout_prob=dropout_rate,
                                 is_test=is_test,
                                 dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        x = encoder_layer(x, d_model, n_head, d_ff, dropout_rate,
                          "bert.%d" % i, is_test=is_test)

    # MLM head: gather the predicted positions, project to the vocab
    gathered = _gather_positions(x, mlm_pos)
    mlm_h = _fc(gathered, d_model, "mlm.transform", act="gelu")
    mlm_logits = _fc(mlm_h, vocab_size, "mlm.out")
    mlm_loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(mlm_logits, mlm_label))

    # NSP head over the [CLS] (first) token
    cls = fluid.layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = fluid.layers.reshape(cls, [-1, d_model])
    pooled = fluid.layers.fc(input=cls, size=d_model, act="tanh",
                             param_attr=ParamAttr(name="pooler.w"),
                             bias_attr=ParamAttr(name="pooler.b"))
    nsp_logits = fluid.layers.fc(input=pooled, size=2,
                                 param_attr=ParamAttr(name="nsp.w"),
                                 bias_attr=ParamAttr(name="nsp.b"))
    nsp_loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    total = fluid.layers.elementwise_add(mlm_loss, nsp_loss)
    return ["input_ids", "segment_ids", "mlm_positions", "mlm_labels",
            "nsp_labels"], total


def _gather_positions(x, positions):
    """x [B,T,D], positions [B,P] -> [B,P,D]: a one-hot [B,P,T] (cast to
    x's dtype) times x in one batched matmul. The gradient reaches x through
    the matmul; one_hot has none."""
    onehot = fluid.layers.one_hot(positions, depth=x.shape[1])   # [B,P,T]
    if onehot.dtype != x.dtype:
        onehot = fluid.layers.cast(onehot, x.dtype)
    return fluid.layers.matmul(onehot, x)                        # [B,P,D]


def training_programs(seed, **cfg):
    """Build the model with ``build``'s keywords ``cfg`` in fresh programs,
    the startup program seeded with ``seed``, and append its training step
    as bench.py's BERT leg does (``Adam(1e-4).minimize``). Returns (main
    program, startup program, total_loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        _, loss = build(**cfg)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def synthetic_batch(batch, seq_len, vocab, max_predictions=20, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(1, vocab, (batch, seq_len)).astype("int64"),
        "segment_ids": rng.randint(0, 2, (batch, seq_len)).astype("int64"),
        "mlm_positions": rng.randint(0, seq_len,
                                     (batch, max_predictions)).astype("int64"),
        "mlm_labels": rng.randint(1, vocab,
                                  (batch, max_predictions, 1)).astype("int64"),
        "nsp_labels": rng.randint(0, 2, (batch, 1)).astype("int64"),
    }
