"""fluid.contrib's decoder API on the port (``paddle_tpu_torch/fluid/
contrib/decoder/beam_search_decoder.py``: InitState, StateCell,
TrainingDecoder, BeamSearchDecoder) against the JAX package's, on the CPU.

- tests/test_api_gap_layers.py's test_contrib_training_decoder and
  test_contrib_beam_search_decoder built by both packages: op for op in
  every block, main and startup; then run on the port, and on both
  executors from the JAX startup state (``fluid.params_from_numpy``): the
  TrainingDecoder's states within 1e-5 of the largest, the beam ids equal
  and their scores within 1e-5.
- ``decode()`` without a scorer (a new fc at every unrolled step) and
  ``InitState`` from a boot tensor (``init_boot``) op for op.
- ``fluid.contrib`` exports the decoder's four names and none of the JAX
  package's contrib names that wait for ROADMAP Queue 1 item 11.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

TOL = 1e-5


def _same_programs(j, t):
    """Two (main, startup) pairs op for op, in every block."""
    for jp, tp in zip(j, t):
        assert step.signature(jp) == step.signature(tp)
        assert len(jp.blocks) == len(tp.blocks)
        for jb, tb in zip(jp.blocks[1:], tp.blocks[1:]):
            assert [(op.type, dict(op.inputs), dict(op.outputs))
                    for op in jb.ops] == \
                [(op.type, dict(op.inputs), dict(op.outputs))
                 for op in tb.ops]


def _training_decoder(fluid):
    """test_contrib_training_decoder's program: (main, startup, out)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 21
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data(name="src", shape=[6, 8], dtype="float32")
        init = fluid.contrib.InitState(init=fluid.layers.reduce_mean(
            src, dim=1))
        cell = fluid.contrib.StateCell(
            inputs={"x": None}, states={"h": init}, out_state="h")

        @cell.state_updater
        def updater(state_cell):
            state_cell.set_state("h", fluid.layers.fc(
                input=[state_cell.get_state("h"),
                       state_cell.get_input("x")], size=8, act="tanh"))

        decoder = fluid.contrib.TrainingDecoder(cell)
        with decoder.block():
            tgt = decoder.step_input(fluid.layers.data(
                name="tgt", shape=[5, 8], dtype="float32"))
            cell.compute_state({"x": tgt})
            decoder.output(cell.out_state())
        out = decoder()
    return main, startup, out


def _beam_decoder(fluid, scorer=False, init_boot=False, end_id=0):
    """test_contrib_beam_search_decoder's program (decode() without a
    scorer; with `scorer` a softmax of one named fc; with `init_boot` the
    state starts as 0.5 shaped by the boot): (main, startup, ids,
    scores)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 22
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        boot = L.data(name="boot", shape=[8], dtype="float32")
        init_ids = L.data(name="init_ids", shape=[1], dtype="int64")
        init_scores = L.data(name="init_scores", shape=[1], dtype="float32")
        init = fluid.contrib.InitState(init_boot=boot, shape=[-1, 8],
                                       value=0.5) if init_boot else \
            fluid.contrib.InitState(init=boot)
        cell = fluid.contrib.StateCell(inputs={"ids": None},
                                       states={"h": init}, out_state="h")

        @cell.state_updater
        def updater(state_cell):
            emb = L.embedding(state_cell.get_input("ids"), size=[12, 8],
                              param_attr=fluid.ParamAttr(name="bsd_emb"))
            emb = L.reshape(emb, [-1, 8])
            state_cell.set_state("h", L.fc(
                input=[state_cell.get_state("h"), emb], size=8,
                act="tanh"))

        def score(prev_ids, prev_scores, sc):
            sc.compute_state({"ids": prev_ids})
            return L.softmax(L.fc(input=sc.out_state(), size=12,
                                  param_attr=fluid.ParamAttr(name="out.w"),
                                  bias_attr=fluid.ParamAttr(name="out.b")))

        decoder = fluid.contrib.BeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=12, word_dim=8,
            topk_size=6, max_len=4, beam_size=2, end_id=end_id)
        ids, scores = decoder.decode(score if scorer else None)
    return main, startup, ids, scores


def _state(fluid, main, startup):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, {v.name: np.asarray(scope.get(v.name))
                        for v in main.global_block().vars.values()
                        if v.persistable and scope.get(v.name) is not None}


def _port_run(main, startup, feeds, fetch, state=None):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.params_from_numpy(state, scope, "cpu")
    return [np.asarray(v) for v in exe.run(main, feed=feeds,
                                           fetch_list=fetch, scope=scope)]


def _rel_max(got, want):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def test_training_decoder_matches_jax():
    j, t = _training_decoder(jfluid), _training_decoder(tfluid)
    _same_programs(j[:2], t[:2])
    assert len(t[0].blocks) == 2
    rng = np.random.RandomState(5)
    feeds = {"src": rng.rand(3, 6, 8).astype("float32"),
             "tgt": rng.rand(3, 5, 8).astype("float32")}
    jexe, jscope, state = _state(jfluid, j[0], j[1])
    want = np.asarray(jexe.run(j[0], feed=feeds, fetch_list=[j[2]],
                               scope=jscope)[0])
    got, = _port_run(t[0], t[1], feeds, [t[2]], state)
    # test_api_gap_layers.py's checks, on the port
    assert got.shape == (3, 5, 8)
    assert np.isfinite(got).all()
    assert _rel_max(got, want) <= TOL


@pytest.mark.parametrize("scorer", [False, True])
def test_beam_search_decoder_matches_jax(scorer):
    j, t = _beam_decoder(jfluid, scorer), _beam_decoder(tfluid, scorer)
    _same_programs(j[:2], t[:2])
    # the updater's fc (two weights, a bias) is new at each of the 4
    # unrolled steps, and so is decode()'s own fc without a scorer
    fcs = {p.name for p in t[0].all_parameters()} - {"bsd_emb"}
    assert len(fcs) == 3 * 4 + (2 if scorer else 2 * 4)
    feeds = {"boot": np.random.RandomState(3).randn(4, 8).astype("float32"),
             "init_ids": np.ones((4, 1), "int64"),
             "init_scores": np.array([[0.0], [-1e9], [0.0], [-1e9]],
                                     "float32")}
    jexe, jscope, state = _state(jfluid, j[0], j[1])
    want_ids, want_scores = [np.asarray(v) for v in jexe.run(
        j[0], feed=feeds, fetch_list=[j[2], j[3]], scope=jscope)]
    got_ids, got_scores = _port_run(t[0], t[1], feeds, [t[2], t[3]], state)
    assert got_ids.shape == (4, 4, 1)          # max_len steps
    np.testing.assert_array_equal(got_ids, want_ids)
    assert _rel_max(got_scores, want_scores) <= TOL


def test_contrib_beam_search_decoder_on_the_port():
    """test_api_gap_layers.py's test_contrib_beam_search_decoder, on the
    port's own startup state."""
    main, startup, ids, scores = _beam_decoder(tfluid)
    feeds = {"boot": np.zeros((2, 8), "float32"),
             "init_ids": np.ones((2, 1), "int64"),
             "init_scores": np.zeros((2, 1), "float32")}
    got_ids, got_scores = _port_run(main, startup, feeds, [ids, scores])
    assert got_ids.shape[1] == 4
    assert np.isfinite(got_scores).all()


def test_init_state_from_a_boot_is_op_for_op():
    j, t = _beam_decoder(jfluid, init_boot=True), \
        _beam_decoder(tfluid, init_boot=True)
    _same_programs(j[:2], t[:2])
    assert j[0].global_block().ops[0].type == \
        "fill_constant_batch_size_like"
    feeds = {"boot": np.zeros((2, 8), "float32"),
             "init_ids": np.ones((2, 1), "int64"),
             "init_scores": np.zeros((2, 1), "float32")}
    _, _, state = _state(jfluid, j[0], j[1])
    got_ids, _ = _port_run(t[0], t[1], feeds, [t[2], t[3]], state)
    assert got_ids.shape == (2, 4, 1)


def test_contrib_exports_the_decoder_alone():
    """contrib exports the decoder and the compression names (quantize,
    QuantizeTranspiler, Calibrator, Compressor), each also a name of the
    JAX package's contrib; the names of ROADMAP Queue 1 item 11 are
    absent."""
    decoder = {"InitState", "StateCell", "TrainingDecoder",
               "BeamSearchDecoder"}
    compression = {"quantize", "QuantizeTranspiler", "Calibrator",
                   "Compressor"}
    assert set(tfluid.contrib.__all__) == {"decoder"} | decoder | \
        compression
    for name in decoder | compression:
        assert hasattr(jfluid.contrib, name)
    assert compression <= set(jfluid.contrib.__all__)
    for name in ("Trainer", "Float16Transpiler", "HDFSClient", "reader",
                 "memory_usage"):
        assert hasattr(jfluid.contrib, name)
        assert not hasattr(tfluid.contrib, name)


@pytest.mark.parametrize("fluid", [jfluid, tfluid], ids=["jax", "port"])
def test_decoder_ignores_end_id_and_parents_in_both_packages(fluid):
    """Both packages' BeamSearchDecoder stacks each step's selections: no
    op reads a beam_search's parent_idx (the states are not reordered by
    parent), no beam_search_decode backtracks them, and end_id changes no
    output (ROADMAP Queue 3)."""
    feeds = {"boot": np.random.RandomState(6).randn(4, 8).astype("float32"),
             "init_ids": np.ones((4, 1), "int64"),
             "init_scores": np.array([[0.0], [-1e9], [0.0], [-1e9]],
                                     "float32")}
    outs = []
    for end_id in (0, 3):
        main, startup, ids, scores = _beam_decoder(fluid, end_id=end_id)
        block = main.global_block()
        parents = {op.output("parent_idx")[0] for op in block.ops
                   if op.type == "beam_search"}
        assert len(parents) == 4
        assert not parents & {n for op in block.ops
                              for n in op.input_arg_names}
        assert "beam_search_decode" not in {op.type for op in block.ops}
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        outs.append([np.asarray(v) for v in exe.run(
            main, feed=feeds, fetch_list=[ids, scores], scope=scope)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
