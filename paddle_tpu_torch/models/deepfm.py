"""DeepFM click-through-rate model: a factorization machine's first- and
second-order terms and a deep MLP over field embeddings.

The port's counterpart of ``paddle_tpu/models/deepfm.py``: the same
``build()`` signature, ops and parameter names (``fm_first``,
``fm_second``, ``fc_0.w_0``, ...). Both embeddings are sparse by default:
their gradients are (values, rows) pairs that the optimizer's sparse update
takes (fluid/sparse_grads.py). The distributed embedding service is not
ported yet.
"""
import numpy as np

import paddle_tpu_torch.fluid as fluid

# bench.py's DEEPFM_CFG and DEEPFM_BATCH
DEEPFM_BENCH_CFG = dict(num_fields=26, vocab_size=100000, embed_dim=16)
DEEPFM_BENCH_BATCH = 4096


def build(num_fields=26, vocab_size=10000, embed_dim=8,
          mlp_dims=(128, 64), sparse=True, distributed=False):
    """Returns (feed names, avg_loss, auc_var). Feeds: feat_ids [B,F] int64,
    label [B,1] float32."""
    if distributed:
        raise NotImplementedError("distributed embeddings are not ported "
                                  "yet; build with distributed=False")
    feat_ids = fluid.layers.data(name="feat_ids", shape=[num_fields],
                                 dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="float32")

    # first order: one scalar weight per feature
    first_emb = fluid.layers.embedding(
        input=feat_ids, size=[vocab_size, 1], is_sparse=sparse,
        is_distributed=distributed,
        param_attr=fluid.ParamAttr(name="fm_first"))       # [B, F, 1]
    first = fluid.layers.reduce_sum(first_emb, dim=[1, 2], keep_dim=False)
    first = fluid.layers.reshape(first, [-1, 1])

    # second order: the FM interaction of the field embeddings
    emb = fluid.layers.embedding(
        input=feat_ids, size=[vocab_size, embed_dim], is_sparse=sparse,
        is_distributed=distributed,
        param_attr=fluid.ParamAttr(name="fm_second"))      # [B, F, K]
    sum_emb = fluid.layers.reduce_sum(emb, dim=1)          # [B, K]
    sum_sq = fluid.layers.square(sum_emb)
    sq_emb = fluid.layers.square(emb)
    sq_sum = fluid.layers.reduce_sum(sq_emb, dim=1)
    fm2 = fluid.layers.scale(
        fluid.layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)
    fm2 = fluid.layers.reduce_sum(fm2, dim=1, keep_dim=True)  # [B,1]

    # deep tower
    deep = fluid.layers.flatten(emb, axis=1)                # [B, F*K]
    for d in mlp_dims:
        deep = fluid.layers.fc(input=deep, size=d, act="relu")
    deep_out = fluid.layers.fc(input=deep, size=1)

    logit = fluid.layers.sums([first, fm2, deep_out])
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
    prob = fluid.layers.sigmoid(logit)
    prob2 = fluid.layers.concat([1.0 - prob, prob], axis=1)
    auc_var, _, _ = fluid.layers.auc(
        input=prob2, label=fluid.layers.cast(label, "int64"))
    return ["feat_ids", "label"], loss, auc_var


def training_programs(seed, **cfg):
    """Build the model with ``build``'s keywords ``cfg`` in fresh programs,
    the startup program seeded with ``seed``, and append its training step
    as bench.py's DeepFM leg does (``Adam(1e-3).minimize``). Returns (main
    program, startup program, avg_loss, auc_var)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        _, loss, auc_var = build(**cfg)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, auc_var


def synthetic_batch(batch, num_fields, vocab, seed=0):
    """bench.py's DeepFM feed: ids uniform over the table, 0/1 labels."""
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, vocab, (batch, num_fields))
            .astype("int64"),
            "label": rng.randint(0, 2, (batch, 1)).astype("float32")}
