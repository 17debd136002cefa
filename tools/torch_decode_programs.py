"""The decoding programs (beam search, the linear-chain CRF, NCE), built on
whichever ``fluid`` module the caller passes: the port's
(``paddle_tpu_torch.fluid``) or the JAX package's (``paddle_tpu.fluid``).
The same code gives the same program on both, op for op, in every block.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m = tool.book_machine_translation(fluid, **tool.MT_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, feed=tool.mt_batch(0, **tool.MT_NARROW),
            fetch_list=[m.loss])

- ``book_machine_translation``: tests/test_book.py's
  ``test_machine_translation_beam_search`` (the reference's
  book/test_machine_translation.py): an embedding and a tanh fc over the
  source, averaged over time, as the first memory of a DynamicRNN decoder
  whose step is one fc over [target embedding, memory] (``dec_fc``, one
  [emb, hid] weight shared by both inputs where emb == hid), an fc
  ``proj`` over the vocabulary, softmax_with_cross_entropy, Adam(5e-3).
  ``MT`` holds the WMT-14 seq2seq's widths that
  tools/torch_control_flow_programs.py's ENC_DEC uses (dictionary 30,000,
  embedding 512, hidden 512, T 32, batch 64); ``MT_NARROW`` the book
  test's. ``mt_decoder`` builds the test's inference program over the
  same parameter names (filled by ``fluid.io.load_persistables``): a
  StateCell whose updater embeds the previous ids and steps ``dec_fc``,
  and a BeamSearchDecoder with a scorer (softmax of ``proj``), top-k 50,
  beam 2, max_len 32, end_id 0 (``MT_BEAM``); ``decode()`` returns each
  step's selections stacked, and the program then backtracks them with
  beam_search_decode (``sentences`` [rows, max_len]), as the reference's
  decoder ends. A request (``mt_request``)
  holds ``sources`` sources, each fed ``beam`` rows (the beam_search
  lowering groups rows by ``beam``), ``init_ids`` 0 and ``init_scores`` 0
  on a source's first row and -1e9 on the others, so that step 0 does not
  select one token twice.
- ``book_label_semantic_roles``: the Fluid book's chapter 7
  (PaddlePaddle/book 07.label_semantic_roles; the reference's
  tests/book/test_label_semantic_roles.py): eight ragged features (word,
  ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark), the six word
  features through one frozen word table ``emb`` (``trainable=False``;
  the book sets ``is_sparse`` on the predicate and mark tables, and a
  frozen table forms no gradient either way), the predicate's ``vemb``
  and the mark's table, each through fc(hidden_dim, tanh), summed; then
  depth 8 of dynamic_lstm(hidden_dim) over the sum of two fc(hidden_dim,
  tanh), alternating is_reverse, with the book's activations (candidate
  relu, gate and cell sigmoid); the sum of two fc(labels, tanh) as the
  emissions; linear_chain_crf with ``crfw`` at the book's
  ``mix_hidden_lr`` 1e-3, its mean minimized by SGD(0.01); then
  crf_decoding over ``crfw`` with the target as Label (``srl_tagger``
  gives the is_test program whose crf_decoding outputs the tags, as a
  tagging request runs it). ``SRL`` holds the
  book's widths: word_dim 32, mark_dim 5, the conll05 dictionaries
  (words 44,068, predicates 3,162, labels 59, marks 2), hidden_dim 512
  passed to fc and dynamic_lstm as the book passes it (an LSTM of 128),
  batch 10 as the book trains. Where the book's value is not what this
  program takes: the word table is the book's shape but seeded random
  (the pre-trained conll05 table is not in the repository); SGD's rate is
  the book's base rate 0.01 (its exponential_decay halves it once in
  100,000 steps, so no window here sees a change); fc runs with
  ``num_flatten_dims=2`` over the padded [B, T, .] batch (the book's
  default 1 flattens a LoD batch's rows); and each fc sum is given the
  words' lengths (``seq_length_var``; fc and sums drop them in both
  packages), so that every dynamic_lstm, the CRF and Viterbi read them.
  Sentence lengths are uniform in [5, 50], padded as the JAX DataFeeder
  pads.
- ``word2vec_nce``: tools/torch_nn_programs.py's word2vec_hsigmoid (the
  book's N-gram word2vec: dictionary 2,073, embedding 32, hidden 256,
  batch 100, SGD(0.001)) with ``nce(num_total_classes=2073)`` and the
  layer's default 10 negatives in place of hsigmoid.

``*_NARROW`` hold the widths of the CPU tests.
"""
import collections

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds")
Decoder = collections.namedtuple("Decoder",
                                 "main startup ids scores sentences feeds")

# ---- the book's machine translation --------------------------------------

MT = dict(vocab=30000, emb=512, hid=512, seq=32, batch=64)
MT_NARROW = dict(vocab=30, emb=16, hid=16, seq=6, batch=8)
MT_BEAM = dict(topk=50, beam=2, max_len=32, end_id=0, sources=8)
MT_BEAM_NARROW = dict(topk=8, beam=2, max_len=6, end_id=0, sources=2)
MT_LR = 5e-3
MT_FEEDS = ["src_w", "tgt_w", "lbl_w"]
MT_REQUEST_FEEDS = ["src_w", "init_ids", "init_scores"]
# init_scores of a source's rows past its first
MT_OTHER_ROWS = -1e9


def _attr(fluid, name):
    return fluid.ParamAttr(name=name)


def book_machine_translation(fluid, seed=44, **widths):
    """The book test's training program at `widths` (MT's keys; MT by
    default): main (with Adam), startup seeded with `seed`, the loss and
    the logits [B, T, V]."""
    w = dict(MT, **widths)
    v, t, emb, hid = w["vocab"], w["seq"], w["emb"], w["hid"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = L.data(name="src_w", shape=[t], dtype="int64")
        tgt = L.data(name="tgt_w", shape=[t], dtype="int64")
        lbl = L.data(name="lbl_w", shape=[t, 1], dtype="int64")
        src_emb = L.embedding(src, size=[v, emb],
                              param_attr=_attr(fluid, "src_emb"))
        enc = L.fc(input=src_emb, size=hid, act="tanh", num_flatten_dims=2,
                   param_attr=_attr(fluid, "enc_fc.w"),
                   bias_attr=_attr(fluid, "enc_fc.b"))
        enc_vec = L.reduce_mean(enc, dim=1)
        tgt_emb = L.embedding(tgt, size=[v, emb],
                              param_attr=_attr(fluid, "tgt_emb"))
        rnn = L.DynamicRNN()
        with rnn.block():
            x = rnn.step_input(tgt_emb)
            h = rnn.memory(init=enc_vec)
            nh = L.fc(input=[x, h], size=hid, act="tanh",
                      param_attr=_attr(fluid, "dec_fc"),
                      bias_attr=_attr(fluid, "dec_fc.b"))
            rnn.update_memory(h, nh)
            rnn.output(nh)
        logits = L.fc(input=rnn(), size=v, num_flatten_dims=2,
                      param_attr=_attr(fluid, "proj"),
                      bias_attr=_attr(fluid, "proj.b"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, lbl))
        fluid.optimizer.Adam(learning_rate=MT_LR).minimize(loss)
    return Model(main, startup, loss, logits, list(MT_FEEDS))


def mt_batch(seed, **widths):
    """The book test's feeds: source ids in [1, V), the target the source
    shifted by one step, the labels the source."""
    w = dict(MT, **widths)
    src = np.random.RandomState(seed).randint(
        1, w["vocab"], (w["batch"], w["seq"])).astype("int64")
    return {"src_w": src, "tgt_w": np.roll(src, 1, axis=1),
            "lbl_w": src[..., None]}


def mt_decoder(fluid, scorer=True, **widths):
    """The book test's beam-search program at `widths` (MT's and MT_BEAM's
    keys): an encoder over src_w as in training, its mean the cell's first
    state, and a BeamSearchDecoder over the training program's parameter
    names; with `scorer` the test's (softmax of proj over the new state),
    else decode()'s own fc. ids and scores [rows, max_len, 1]."""
    w = dict(MT, **dict(MT_BEAM, **widths))
    v, t, emb, hid = w["vocab"], w["seq"], w["emb"], w["hid"]
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = L.data(name="src_w", shape=[t], dtype="int64")
        semb = L.embedding(src, size=[v, emb],
                           param_attr=_attr(fluid, "src_emb"))
        enc = L.fc(input=semb, size=hid, act="tanh", num_flatten_dims=2,
                   param_attr=_attr(fluid, "enc_fc.w"),
                   bias_attr=_attr(fluid, "enc_fc.b"))
        boot = L.reduce_mean(enc, dim=1)
        init_ids = L.data(name="init_ids", shape=[1], dtype="int64")
        init_scores = L.data(name="init_scores", shape=[1], dtype="float32")
        cell = fluid.contrib.StateCell(
            inputs={"ids": None}, states={"h": fluid.contrib.InitState(
                init=boot)}, out_state="h")

        @cell.state_updater
        def updater(sc):
            e = L.embedding(sc.get_input("ids"), size=[v, emb],
                            param_attr=_attr(fluid, "tgt_emb"))
            e = L.reshape(e, [-1, emb])
            sc.set_state("h", L.fc(input=[e, sc.get_state("h")], size=hid,
                                   act="tanh",
                                   param_attr=_attr(fluid, "dec_fc"),
                                   bias_attr=_attr(fluid, "dec_fc.b")))

        def score(prev_ids, prev_scores, sc):
            sc.compute_state({"ids": prev_ids})
            return L.softmax(L.fc(input=sc.out_state(), size=v,
                                  param_attr=_attr(fluid, "proj"),
                                  bias_attr=_attr(fluid, "proj.b")))

        decoder = fluid.contrib.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=v, word_dim=emb,
            topk_size=w["topk"], max_len=w["max_len"], beam_size=w["beam"],
            end_id=w["end_id"])
        ids, scores = decoder.decode(score if scorer else None)
        # the steps' selections backtracked, as the reference's decoder
        # ends (the JAX package's stops at the stacked selections)
        block = main.global_block()
        steps = [op for op in block.ops if op.type == "beam_search"]

        def stacked(slot):
            return L.stack([block.var(op.output(slot)[0]) for op in steps],
                           axis=0)
        sentences, _ = L.beam_search_decode(
            stacked("selected_ids"), stacked("parent_idx"),
            block.var(steps[-1].output("selected_scores")[0]),
            beam_size=w["beam"], end_id=w["end_id"])
    return Decoder(main, startup, ids, scores, sentences,
                   list(MT_REQUEST_FEEDS))


def mt_request(seed, **widths):
    """A request of `sources` sources (ids in [1, V)), each fed `beam` rows;
    init_ids 0, init_scores 0 on a source's first row and MT_OTHER_ROWS on
    the others."""
    w = dict(MT, **dict(MT_BEAM, **widths))
    src = np.random.RandomState(seed).randint(
        1, w["vocab"], (w["sources"], w["seq"])).astype("int64")
    rows = w["sources"] * w["beam"]
    scores = np.full((w["sources"], w["beam"]), MT_OTHER_ROWS, np.float32)
    scores[:, 0] = 0.0
    return {"src_w": np.repeat(src, w["beam"], axis=0),
            "init_ids": np.zeros((rows, 1), np.int64),
            "init_scores": scores.reshape(rows, 1)}


# ---- the book's semantic role labelling -----------------------------------

SRL = dict(word_dict=44068, pred_dict=3162, label_dict=59, mark_dict=2,
           word_dim=32, mark_dim=5, hidden=512, depth=8, batch=10,
           min_len=5, max_len=50)
SRL_NARROW = dict(word_dict=40, pred_dict=12, label_dict=6, mark_dict=2,
                  word_dim=8, mark_dim=3, hidden=16, depth=3, batch=4,
                  min_len=2, max_len=7)
SRL_LR = 0.01
SRL_MIX_HIDDEN_LR = 1e-3
SRL_WORDS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data"]
SRL_INPUTS = SRL_WORDS + ["verb_data", "mark_data", "target"]
SRL_FEEDS = [f for n in SRL_INPUTS for f in (n, n + "@LEN")]


def _db_lstm(fluid, feats, w):
    """The book's db_lstm over the eight ragged features: the emissions
    [B, T, labels] with the words' lengths."""
    L = fluid.layers
    lens = feats["word_data"].seq_length_var

    def ragged(x):
        x.seq_length_var = lens
        return x

    def fc(x, size):
        return L.fc(input=x, size=size, act="tanh", num_flatten_dims=2)

    embs = [L.embedding(size=[w["word_dict"], w["word_dim"]], input=feats[n],
                        param_attr=fluid.ParamAttr(name="emb",
                                                   trainable=False))
            for n in SRL_WORDS]
    embs.append(L.embedding(input=feats["verb_data"],
                            size=[w["pred_dict"], w["word_dim"]],
                            dtype="float32", is_sparse=True,
                            param_attr="vemb"))
    embs.append(L.embedding(input=feats["mark_data"],
                            size=[w["mark_dict"], w["mark_dim"]],
                            dtype="float32", is_sparse=True))
    hidden_0 = ragged(L.sums(input=[fc(e, w["hidden"]) for e in embs]))
    lstm_0 = L.dynamic_lstm(input=hidden_0, size=w["hidden"],
                            candidate_activation="relu",
                            gate_activation="sigmoid",
                            cell_activation="sigmoid")[0]
    tmp = [hidden_0, lstm_0]
    for i in range(1, w["depth"]):
        mix = ragged(L.sums(input=[fc(tmp[0], w["hidden"]),
                                   fc(tmp[1], w["hidden"])]))
        lstm = L.dynamic_lstm(input=mix, size=w["hidden"],
                              candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid",
                              is_reverse=(i % 2) == 1)[0]
        tmp = [mix, lstm]
    return ragged(L.sums(input=[fc(tmp[0], w["label_dict"]),
                                fc(tmp[1], w["label_dict"])]))


def book_label_semantic_roles(fluid, seed=45, **widths):
    """The book's chapter 7 at `widths` (SRL's keys; SRL by default): main
    (the CRF's mean cost minimized by SGD, then crf_decoding with the
    target as Label), startup seeded with `seed`, the loss and `out`, the
    decoding's 0/1 agreement [B, T]."""
    w = dict(SRL, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feats = {n: L.data(name=n, shape=[-1, 1], dtype="int64",
                           lod_level=1) for n in SRL_INPUTS}
        feature_out = _db_lstm(fluid, feats, w)
        crf_cost = L.linear_chain_crf(
            input=feature_out, label=feats["target"],
            param_attr=fluid.ParamAttr(name="crfw",
                                       learning_rate=SRL_MIX_HIDDEN_LR))
        loss = L.mean(crf_cost)
        fluid.optimizer.SGD(learning_rate=SRL_LR).minimize(loss)
        decode = L.crf_decoding(input=feature_out,
                                param_attr=fluid.ParamAttr(name="crfw"),
                                label=feats["target"])
    return Model(main, startup, loss, decode, list(SRL_FEEDS))


def srl_tagger(model):
    """The is_test program of ``book_label_semantic_roles`` whose
    crf_decoding outputs the tags themselves (its Label input dropped),
    as a tagging request runs it: fetch ``model.out``."""
    test = model.main.clone(for_test=True)
    for op in test.global_block().ops:
        if op.type == "crf_decoding":
            op.inputs.pop("Label")
    return test


def _padded_len(longest):
    """The JAX DataFeeder's padded length: the next power of two of the
    longest row, at least 8."""
    t = 8
    while t < longest:
        t <<= 1
    return t


def srl_batch(seed, **widths):
    """A seeded batch of the eight features and the target at `widths`:
    lengths uniform in [min_len, max_len], padded with zeros to the JAX
    DataFeeder's length; the words uniform over the dictionary; the five
    context words and the predicate one id a sentence, repeated over it (as
    conll05's reader gives them); the mark 1 on the predicate's position
    and its neighbours; the labels uniform. Each feature's lengths under
    ``<name>@LEN``."""
    w = dict(SRL, **widths)
    rng = np.random.RandomState(seed)
    b = w["batch"]
    lens = rng.randint(w["min_len"], w["max_len"] + 1, b).astype(np.int64)
    t = _padded_len(int(lens.max()))
    live = np.arange(t)[None, :] < lens[:, None]

    def per_token(high):
        return rng.randint(0, high, (b, t))

    def per_sentence(high):
        return np.repeat(rng.randint(0, high, (b, 1)), t, axis=1)
    at = (rng.rand(b) * lens).astype(np.int64)
    mark = (np.abs(np.arange(t)[None, :] - at[:, None]) <= 1)
    vals = {"word_data": per_token(w["word_dict"]),
            "verb_data": per_sentence(w["pred_dict"]),
            "mark_data": mark.astype(np.int64) % w["mark_dict"],
            "target": per_token(w["label_dict"])}
    for n in SRL_WORDS[1:]:
        vals[n] = per_sentence(w["word_dict"])
    feed = {}
    for n in SRL_INPUTS:
        feed[n] = np.where(live, vals[n], 0).astype(np.int64)[..., None]
        feed[n + "@LEN"] = lens.copy()
    return feed


# ---- word2vec with NCE -----------------------------------------------------

W2V = dict(dict_size=2073, emb=32, hidden=256, batch=100)
W2V_NARROW = dict(dict_size=37, emb=8, hidden=16, batch=6)
W2V_N = 5
W2V_LR = 0.001


def word2vec_nce(fluid, seed=1, **widths):
    """The book's N-gram model (four is_sparse lookups of one table,
    concat, fc(hidden, sigmoid)) with NCE over the dictionary (10 uniform
    negatives a row) in place of its softmax; SGD(W2V_LR)."""
    w = dict(W2V, **widths)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    L = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = [L.data(name="w%d" % i, shape=[1], dtype="int64")
                 for i in range(W2V_N)]
        embs = [L.embedding(input=x, size=[w["dict_size"], w["emb"]],
                            dtype="float32", is_sparse=True,
                            param_attr=fluid.ParamAttr(name="shared_w"))
                for x in words[:-1]]
        h = L.fc(input=L.concat(input=embs, axis=1), size=w["hidden"],
                 act="sigmoid")
        cost = L.nce(input=h, label=words[-1],
                     num_total_classes=w["dict_size"],
                     param_attr=fluid.ParamAttr(name="nce.w"),
                     bias_attr=fluid.ParamAttr(name="nce.b"))
        loss = L.mean(cost)
        fluid.optimizer.SGD(learning_rate=W2V_LR).minimize(loss)
    return Model(main, startup, loss, cost, ["w%d" % i for i in range(W2V_N)])


def w2v_batch(seed, **widths):
    """Five words a row, uniform over the dictionary."""
    w = dict(W2V, **widths)
    words = np.random.RandomState(seed).randint(0, w["dict_size"],
                                                (w["batch"], W2V_N))
    return {"w%d" % i: words[:, i:i + 1].astype("int64")
            for i in range(W2V_N)}


PROGRAMS = {"book_machine_translation": (book_machine_translation, mt_batch,
                                         MT_NARROW),
            "book_label_semantic_roles": (book_label_semantic_roles,
                                          srl_batch, SRL_NARROW),
            "word2vec_nce": (word2vec_nce, w2v_batch, W2V_NARROW)}
