"""The decoding slice's programs on the port against the JAX package, on
the CPU: tools/torch_decode_programs.py's book_machine_translation (with
its beam-search program), book_label_semantic_roles and word2vec_nce.

- Each program gives the JAX package's op for op, in every block, main and
  startup, at the CPU tests' widths and (building only) at its full
  widths; so does the beam-search program, with and without a scorer.
- STEPS steps of each at narrow widths on both executors, each from the
  JAX executor's state before it (``fluid.params_from_numpy``): every op
  of the port's plan run on the JAX step's values of its inputs within
  1e-4 of its largest JAX output and every integer output (Viterbi's
  agreement, the NCE labels) exactly (``torch_resnet_step.replay``); the
  loss within 1e-5 relative; every gradient within 1e-5 of its largest
  JAX value; Adam's parameters held by ``adam_param_misses``, every other
  persistable within 1e-5. Then STEPS free-running steps of the port from
  the JAX startup state: each loss within 1e-5 of the JAX executor's. The
  packages' NCE draws differ (different generators), so the port's nce
  takes the JAX step's negatives here (its invariants are held in
  tests/test_torch_decode_ops.py).
- The book's translation round trip across the packages: the JAX
  executor trains and saves the narrow model, the port loads the
  checkpoint, and its beam search gives the JAX package's ids exactly and
  its scores within 1e-5.
- tests/test_book.py's test_machine_translation_beam_search and
  test_label_semantic_roles_crf on the port; the SRL tagging program
  (``srl_tagger``) gives the JAX package's tags.
- New ids at the SRL batch's pad positions leave the loss and every
  updated persistable bit for bit.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import decode_ops
from paddle_tpu_torch.fluid.ops import registry as treg

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_decode_programs")

TOL = 1e-5
STEPS = 2
NAMES = sorted(tool.PROGRAMS)
# blocks of each main program: MT's DynamicRNN step block
BLOCKS = {"book_machine_translation": 2, "book_label_semantic_roles": 1,
          "word2vec_nce": 1}
BEAM_NARROW = dict(tool.MT_NARROW, **tool.MT_BEAM_NARROW)


def _build(fluid, name, widths="narrow"):
    build, _, narrow = tool.PROGRAMS[name]
    return build(fluid, **(narrow if widths == "narrow" else {}))


def _batch(name, k):
    _, batch, narrow = tool.PROGRAMS[name]
    return batch(k, **narrow)


def _blocks_equal(j, t):
    assert len(t.blocks) == len(j.blocks)
    for jb, tb in zip(j.blocks[1:], t.blocks[1:]):
        assert [(op.type, dict(op.inputs), dict(op.outputs))
                for op in jb.ops] == \
            [(op.type, dict(op.inputs), dict(op.outputs)) for op in tb.ops]


@pytest.mark.parametrize("widths", ["narrow", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_program_is_op_for_op_the_jax_packages(name, widths):
    j, t = _build(jfluid, name, widths), _build(tfluid, name, widths)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    assert len(t.main.blocks) == BLOCKS[name]
    _blocks_equal(j.main, t.main)
    assert t.feeds == j.feeds


@pytest.mark.parametrize("widths,scorer", [("narrow", True),
                                           ("narrow", False),
                                           ("full", True)])
def test_beam_search_program_is_op_for_op(widths, scorer):
    kw = BEAM_NARROW if widths == "narrow" else {}
    j = tool.mt_decoder(jfluid, scorer=scorer, **kw)
    t = tool.mt_decoder(tfluid, scorer=scorer, **kw)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    steps = tool.MT_BEAM["max_len"] if widths == "full" else \
        tool.MT_BEAM_NARROW["max_len"]
    types = [op.type for op in t.main.global_block().ops]
    assert types.count("beam_search") == steps
    assert types.count("beam_search_decode") == 1


def _jax_state(j, jscope):
    return {v.name: np.asarray(jscope.get(v.name))
            for v in j.main.global_block().vars.values()
            if v.persistable and jscope.get(v.name) is not None}


def _inter(block):
    return sorted({n for op in block.ops for n in op.output_arg_names
                   if n != "@EMPTY@" and not block.var(n).persistable})


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """STEPS steps of the JAX executor from its startup state: (that
    state, the intermediates fetched, and for each step its feed, their
    values and the state after)."""
    j = _build(jfluid, name)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(j.startup, scope=jscope)
    start = state = _jax_state(j, jscope)
    inter = _inter(j.main.global_block())
    steps = []
    for k in range(STEPS):
        feed = _batch(name, 10 + k)
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            j.main, feed=feed, fetch_list=inter, scope=jscope))))
        state = {n: np.asarray(jscope.get(n)) for n in state}
        steps.append((feed, vals, state))
    return start, inter, steps


def _jax_draws(name, program):
    """A port nce lowering that takes the negatives of the JAX step (the
    same at every step: the JAX lowering draws from (seed, batch)), or
    None for a program without nce."""
    ops = [op for op in program.global_block().ops if op.type == "nce"]
    if not ops:
        return None
    _, _, steps = _jax_steps(name)
    labels = steps[0][1][ops[0].output("SampleLabels")[0]]
    neg = torch.from_numpy(np.ascontiguousarray(labels[:, 1:])).long()

    def lower(ctx, inputs, attrs):
        return decode_ops.nce_forward(
            inputs["Input"][0], inputs["Label"][0], inputs["Weight"][0],
            inputs["Bias"][0], neg)
    return lower


@pytest.fixture
def jax_draws(monkeypatch):
    def patch(name, program):
        lower = _jax_draws(name, program)
        if lower is not None:
            monkeypatch.setitem(treg._LOWERINGS, "nce", lower)
    return patch


def _rel_max(got, want):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_steps_in_lockstep_with_jax_executor(name, jax_draws):
    t = _build(tfluid, name)
    jax_draws(name, t.main)
    state, _, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    params = [p.name for p in t.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params]
    ints = {"crf_decoding", "nce", "beam_search"}
    for feed, vals, after in steps:
        tfluid.params_from_numpy(state, tscope, "cpu")
        got = texe.run(t.main, feed=feed, fetch_list=[t.loss.name] + grads,
                       scope=tscope)
        errs = step.replay(t.main, [t.loss.name, t.out.name], feed, state,
                           after, vals)
        worst = max(errs, key=lambda e: e[2])
        assert worst[2] <= step.OP_TOL["float32"], worst
        for op_type, n, e in errs:
            if op_type in ints and t.main.global_block().var(n).dtype == \
                    "int64":
                assert e == 0.0, (op_type, n, e)
        want = float(vals[t.loss.name])
        assert abs(float(got[0]) - want) <= TOL * abs(want)
        for n, g in zip(grads, got[1:]):
            assert _rel_max(g, vals[n]) <= TOL, n
        got_after = {n: tscope.get(n) for n in state}
        if any(op.type == "adam" for op in t.main.global_block().ops):
            misses = step.adam_param_misses(
                t.main, state, got_after, after, dict(zip(grads, got[1:])),
                {g: vals[g] for g in grads})
            assert sorted(misses) == sorted(params)
            assert sum(misses.values()) == 0, misses
        for n in state:
            if n not in params or not any(
                    op.type == "adam" for op in t.main.global_block().ops):
                assert _rel_max(got_after[n], after[n]) <= TOL, n
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_free_running_losses_match_the_jax_executor(name, jax_draws):
    t = _build(tfluid, name)
    jax_draws(name, t.main)
    state, _, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(state, tscope, "cpu")
    for k, (feed, vals, _) in enumerate(steps):
        want = float(vals[t.loss.name])
        got = float(np.asarray(texe.run(t.main, feed=feed,
                                        fetch_list=[t.loss],
                                        scope=tscope)[0]))
        assert abs(got - want) <= TOL * abs(want), (k, got, want)


def _train_and_save(fluid, dirname, steps=3):
    m = tool.book_machine_translation(fluid, **tool.MT_NARROW)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(m.startup)
        for k in range(steps):
            exe.run(m.main, feed=tool.mt_batch(k, **tool.MT_NARROW),
                    fetch_list=[m.loss])
        fluid.io.save_persistables(exe, dirname, main_program=m.main)
    return m


def _decode(fluid, m, dirname, feed):
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        fluid.io.load_persistables(exe, dirname, main_program=m.main)
        dec = tool.mt_decoder(fluid, **BEAM_NARROW)
        return [np.asarray(v) for v in exe.run(
            dec.main, feed=feed,
            fetch_list=[dec.ids, dec.scores, dec.sentences])]


def test_beam_search_from_the_jax_checkpoint_matches_jax(tmp_path):
    """The JAX executor trains the narrow model 3 steps and saves it; the
    port loads the checkpoint: its beam ids and backtracked sentences equal
    the JAX package's and its scores lie within 1e-5."""
    dirname = str(tmp_path / "mt")
    jm = _train_and_save(jfluid, dirname)
    tm = tool.book_machine_translation(tfluid, **tool.MT_NARROW)
    feed = tool.mt_request(3, **BEAM_NARROW)
    want = _decode(jfluid, jm, dirname, feed)
    got = _decode(tfluid, tm, dirname, feed)
    rows = tool.MT_BEAM_NARROW["sources"] * tool.MT_BEAM_NARROW["beam"]
    assert got[0].shape == (rows, tool.MT_BEAM_NARROW["max_len"], 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel_max(got[1], want[1]) <= TOL


def test_machine_translation_beam_search(tmp_path):
    """tests/test_book.py's test_machine_translation_beam_search on the
    port: 30 Adam steps lower the loss by a fifth, save_persistables, and a
    fresh scope's load_persistables serves the beam search."""
    m = tool.book_machine_translation(tfluid, **tool.MT_NARROW)
    feed = tool.mt_batch(7, **tool.MT_NARROW)
    exe = tfluid.Executor(tfluid.CPUPlace())
    dirname = str(tmp_path / "mt")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(m.startup)
        losses = [float(np.asarray(exe.run(m.main, feed=feed,
                                           fetch_list=[m.loss])[0]))
                  for _ in range(30)]
        assert losses[-1] < losses[0] * 0.8, losses[::10]
        tfluid.io.save_persistables(exe, dirname, main_program=m.main)
    b = 2
    out_ids, out_scores, _ = _decode(tfluid, m, dirname, {
        "src_w": feed["src_w"][:b], "init_ids": np.zeros((b, 1), "int64"),
        "init_scores": np.zeros((b, 1), "float32")})
    assert out_ids.shape[1] == tool.MT_NARROW["seq"]
    assert np.isfinite(out_scores).all()


def test_label_semantic_roles_crf():
    """tests/test_book.py's test_label_semantic_roles_crf on the port: 25
    SGD steps of the CRF's mean (path - logZ, which both packages return:
    ROADMAP Queue 3) end below the first, and crf_decoding over the shared
    crfw gives tags in range."""
    fluid = tfluid
    V, T, NTAG, EMB = 25, 5, 4, 12
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 45
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        word = fluid.layers.data(name="word", shape=[T], dtype="int64")
        pred = fluid.layers.data(name="pred", shape=[T], dtype="int64")
        target = fluid.layers.data(name="target", shape=[T], dtype="int64")
        feat = fluid.layers.concat(
            [fluid.layers.embedding(word, size=[V, EMB]),
             fluid.layers.embedding(pred, size=[V, EMB])], axis=2)
        hidden = fluid.layers.fc(input=feat, size=NTAG, num_flatten_dims=2)
        crf_cost = fluid.layers.linear_chain_crf(
            input=hidden, label=target,
            param_attr=fluid.ParamAttr(name="crfw"))
        avg_cost = fluid.layers.mean(crf_cost)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    rng = np.random.RandomState(8)
    wv = rng.randint(0, V, (6, T)).astype("int64")
    pv = rng.randint(0, V, (6, T)).astype("int64")
    tv = (wv % NTAG).astype("int64")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        vals = [float(np.asarray(exe.run(
            main, feed={"word": wv, "pred": pv, "target": tv},
            fetch_list=[avg_cost])[0])) for _ in range(25)]
        assert vals[-1] < vals[0], vals[::8]
        infer, istart = fluid.Program(), fluid.Program()
        with fluid.program_guard(infer, istart), fluid.unique_name.guard():
            word_i = fluid.layers.data(name="word", shape=[T], dtype="int64")
            pred_i = fluid.layers.data(name="pred", shape=[T], dtype="int64")
            feat_i = fluid.layers.concat(
                [fluid.layers.embedding(word_i, size=[V, EMB]),
                 fluid.layers.embedding(pred_i, size=[V, EMB])], axis=2)
            hid_i = fluid.layers.fc(input=feat_i, size=NTAG,
                                    num_flatten_dims=2)
            decode = fluid.layers.crf_decoding(
                input=hid_i, param_attr=fluid.ParamAttr(name="crfw"))
        tags, = exe.run(infer, feed={"word": wv, "pred": pv},
                        fetch_list=[decode])
    assert tags.shape[:2] == (6, T)
    assert ((tags >= 0) & (tags < NTAG)).all()


def test_tagger_gives_the_jax_packages_tags():
    """tool.srl_tagger (the is_test program whose crf_decoding outputs the
    tags) op for op in both packages; from the JAX startup state the port's
    tags equal the JAX package's."""
    j = _build(jfluid, "book_label_semantic_roles")
    t = _build(tfluid, "book_label_semantic_roles")
    jt, tt = tool.srl_tagger(j), tool.srl_tagger(t)
    assert step.signature(jt) == step.signature(tt)
    crf = [op for op in tt.global_block().ops if op.type == "crf_decoding"]
    assert len(crf) == 1 and "Label" not in crf[0].inputs
    feed = _batch("book_label_semantic_roles", 5)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(j.startup, scope=jscope)
    want = np.asarray(jexe.run(jt, feed=feed, fetch_list=[j.out.name],
                               scope=jscope)[0])
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(_jax_state(j, jscope), tscope, "cpu")
    got, = texe.run(tt, feed=feed, fetch_list=[t.out.name], scope=tscope)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < tool.SRL_NARROW["label_dict"])).all()


def test_srl_pad_content_changes_nothing():
    m = _build(tfluid, "book_label_semantic_roles")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(m.startup, scope=scope)
    names = [n for n, v in m.main.global_block().vars.items()
             if v.persistable and scope.get(n) is not None]
    state = {n: scope.get(n) for n in names}
    feed = _batch("book_label_semantic_roles", 3)
    repadded = dict(feed)
    lens = feed["word_data@LEN"]
    rng = np.random.RandomState(4)
    for n in tool.SRL_INPUTS:
        ids = feed[n].copy()
        pad = np.arange(ids.shape[1])[None, :] >= lens[:, None]
        ids[pad] = rng.randint(1, 2, int(pad.sum()))[:, None]
        repadded[n] = ids
    assert pad.any()
    runs = []
    for f in (feed, repadded):
        sc = tfluid.Scope()
        for n, v in state.items():
            sc.set(n, v.clone())
        loss, = exe.run(m.main, feed=f, fetch_list=[m.loss], scope=sc)
        runs.append((loss, {n: np.asarray(sc.get(n)) for n in names}))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for n in names:
        np.testing.assert_array_equal(runs[0][1][n], runs[1][1][n], n)
