"""The port's fluid.io (paddle_tpu_torch/fluid/io.py) against the JAX
package's, on the CPU.

- Both save layouts (one file a var, bf16 ones as .bf16.npy; one .npz) and
  the dtype each loads back as. Through the .npz a bf16 parameter comes
  back float32 in the JAX package and bfloat16 in the port (ROADMAP,
  Queue 3).
- The whole artifact directory that save_inference_model writes,
  ``__manifest__.json`` included, is byte for byte the JAX package's, for a
  small bf16 Transformer and ResNet-cifar10 of depth 8 with the JAX weights
  carried over by params_from_numpy; each package serves the other's
  artifact, held to the JAX executor's logits at the port's serving
  tolerances (tests/test_torch_transformer.py: 3e-2 of max |logit| in
  bf16; tests/test_torch_resnet.py: 1e-4 in f32).
- A failed export leaves the previous artifact as it was; checkpoints fall
  back to ``.old``; a CPU resume of a Transformer with dropout is bit for
  bit, and a resume without the random streams is not; a JAX checkpoint's
  RNG keys raise a warning; the save and load host ops.

Every test checks that no export staging dir is left behind.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

SMALL_TRANSFORMER = dict(n_layer=1, d_model=128, n_head=2, d_ff=256,
                         seq_len=16, src_vocab=64, tgt_vocab=64,
                         dtype="bfloat16")
SERVE_TOL = {"transformer": 3e-2, "resnet": 1e-4}


@pytest.fixture(autouse=True)
def _no_staging_debris():
    yield
    assert tio._live_export_staging() == []


def _cpu():
    return tfluid.Executor(tfluid.CPUPlace())


def _tree(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _fc_programs(fluid):
    """x [6] -> cast bf16 -> fc (w [6, 8] bf16, b [8] bf16) -> cast f32."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(input=fluid.layers.cast(x, "bfloat16"), size=8,
                            param_attr=fluid.ParamAttr(name="w"),
                            bias_attr=fluid.ParamAttr(name="b"))
        out = fluid.layers.cast(h, "float32")
    return main, startup, out


def _logits(main):
    block = main.global_block()
    op = [o for o in block.ops if o.type == "softmax_with_cross_entropy"][0]
    return block.var(op.input("Logits")[0])


def _model(kind, fluid):
    """(main, startup, feed names, logits var, a feed) of a small model
    built with is_test=True."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if kind == "transformer":
            m = jtransformer if fluid is jfluid else ttransformer
            m.build(is_test=True, **SMALL_TRANSFORMER)
            feeds = ["src_ids", "tgt_ids"]
            b = m.synthetic_batch(3, 16, 64, seed=2)
            feed = {n: b[n] for n in feeds}
        else:
            m = jresnet if fluid is jfluid else tresnet
            m.build(dataset="cifar10", depth=8, is_test=True)
            feeds = ["img"]
            feed = {"img": np.random.RandomState(2).rand(
                3, 3, 32, 32).astype("float32")}
    return main, startup, feeds, _logits(main), feed


def _jax_model(kind):
    main, startup, feeds, logits, feed = _model(kind, jfluid)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    # running statistics away from (0, 1), so that they matter
    rng = np.random.RandomState(3)
    for v in main.list_vars():
        if v.persistable and "batch_norm" in v.name and \
                v.name.endswith((".w_1", ".w_2")):
            scope.set(v.name, rng.uniform(0.5, 1.5, v.shape).astype("float32"))
    return main, exe, scope, feeds, logits, feed


def _port_model(kind, jscope):
    """The port's model with every persistable of the JAX scope."""
    main, startup, feeds, logits, feed = _model(kind, tfluid)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.params_from_numpy(
        {v.name: np.asarray(jscope.get(v.name)) for v in main.list_vars()
         if v.persistable and scope.get(v.name) is not None}, scope, "cpu")
    return main, exe, scope, feeds, logits, feed


def _jax_serve(dirname, feed):
    exe, scope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        prog, feeds, fetches = jfluid.io.load_inference_model(dirname, exe)
        return np.asarray(exe.run(prog, feed=feed)[0])


def _port_serve(dirname, feed):
    exe, scope = _cpu(), tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, feeds, fetches = tfluid.io.load_inference_model(dirname, exe)
    assert sorted(feeds) == sorted(feed)
    return exe.run(prog, feed=feed, scope=scope)[0]


@pytest.mark.parametrize("filename", [None, "params"])
def test_save_layouts_and_dtypes(tmp_path, filename):
    main, startup, _ = _fc_programs(tfluid)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "p")
    with tfluid.scope_guard(scope):
        tfluid.io.save_params(exe, d, main, filename=filename)
    files = sorted(os.listdir(d))
    assert files == (["b.bf16.npy", "w.bf16.npy"] if filename is None
                     else ["params.npz"])
    raw = np.load(os.path.join(d, "w.bf16.npy")) if filename is None \
        else np.load(os.path.join(d, "params.npz"))["w"]
    assert raw.dtype == np.float32
    back = tfluid.Scope()
    with tfluid.scope_guard(back):
        tfluid.io.load_params(exe, d, main, filename=filename)
    for name in ("w", "b"):
        assert back.get(name).dtype == torch.bfloat16
        assert back.get(name).device.type == "cpu"
        assert torch.equal(back.get(name), scope.get(name))


def test_npz_dtype_differs_from_the_jax_package(tmp_path):
    """The same combined .npz, loaded by each package: the JAX package
    leaves the bf16 weight float32, the port casts it to bfloat16."""
    jmain, jstartup, _ = _fc_programs(jfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    d = str(tmp_path / "m")
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        assert str(np.asarray(jscope.get("w")).dtype) == "bfloat16"
        jfluid.io.save_params(jexe, d, jmain, filename="params")
        back = jfluid.Scope()
        with jfluid.scope_guard(back):
            jfluid.io.load_params(jexe, d, jmain, filename="params")
        assert np.asarray(back.get("w")).dtype == np.float32
    tmain, _, _ = _fc_programs(tfluid)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        tfluid.io.load_params(_cpu(), d, tmain, filename="params")
    assert tscope.get("w").dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tscope.get("w").float().numpy(),
        np.asarray(jscope.get("w")).astype(np.float32))


@pytest.mark.parametrize("kind", ["transformer", "resnet"])
def test_artifact_is_byte_for_byte_the_jax_packages(tmp_path, kind):
    jmain, jexe, jscope, feeds, jlogits, feed = _jax_model(kind)
    tmain, texe, tscope, _, tlogits, _ = _port_model(kind, jscope)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, feeds, [jlogits], jexe,
                                       main_program=jmain)
    with tfluid.scope_guard(tscope):
        names = tfluid.io.save_inference_model(tdir, feeds, [tlogits], texe,
                                               main_program=tmain)
    assert names == [tlogits.name]
    jtree, ttree = _tree(jdir), _tree(tdir)
    assert sorted(jtree) == sorted(ttree)
    assert "__model__" in ttree and "__manifest__.json" in ttree
    for rel in jtree:
        assert ttree[rel] == jtree[rel], rel
    manifest = json.loads(ttree["__manifest__.json"])
    assert manifest["meta"]["feeds"] == feeds
    assert set(manifest["files"]) == set(ttree) - {"__manifest__.json"}


@pytest.mark.parametrize("kind", ["transformer", "resnet"])
def test_each_package_serves_the_others_artifact(tmp_path, kind):
    jmain, jexe, jscope, feeds, jlogits, feed = _jax_model(kind)
    tmain, texe, tscope, _, tlogits, _ = _port_model(kind, jscope)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, feeds, [jlogits], jexe,
                                       main_program=jmain)
    want = _jax_serve(jdir, feed)
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(tdir, feeds, [tlogits], texe,
                                       main_program=tmain)
    tol = SERVE_TOL[kind] * np.abs(want).max()
    port_of_jax = _port_serve(jdir, feed)
    jax_of_port = _jax_serve(tdir, feed)
    assert port_of_jax.shape == jax_of_port.shape == want.shape
    assert np.abs(port_of_jax - want).max() <= tol
    assert np.abs(jax_of_port - want).max() <= tol
    # the port's own artifact serves what the in-memory program computes
    own = _port_serve(tdir, feed)
    np.testing.assert_array_equal(
        own, texe.run(tmain, feed=feed, fetch_list=[tlogits],
                      scope=tscope)[0])


def test_fetch_ops_come_before_the_fetch_list(tmp_path):
    """As in the JAX executor: the fetch ops' values, then fetch_list's."""
    main, startup, out = _fc_programs(tfluid)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "m")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main)
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
    x = {"x": np.random.RandomState(0).rand(4, 6).astype("float32")}
    assert [op.type for op in prog.global_block().ops] == \
        ["feed", "cast", "mul", "elementwise_add", "cast", "fetch"]
    with_vars = exe.run(prog, feed=x, fetch_list=fetches, scope=scope)
    alone = exe.run(prog, feed=x, scope=scope)
    with_name = exe.run(prog, feed=x, fetch_list=[fetches[0].name],
                        scope=scope)
    assert (len(with_vars), len(alone), len(with_name)) == (2, 1, 2)
    for r in with_vars + with_name:
        np.testing.assert_array_equal(r, alone[0])
    with pytest.raises(ValueError, match="missing from feed"):
        exe.run(prog, feed={}, scope=scope)
    # run_steps skips the feed and fetch ops
    stacked = {"x": np.stack([x["x"]] * 2)}
    steps, = exe.run_steps(prog, feed=stacked, n_steps=2,
                           fetch_list=fetches, scope=scope)
    np.testing.assert_array_equal(steps[1], alone[0])


def test_failed_export_leaves_the_previous_artifact(tmp_path, monkeypatch):
    main, startup, out = _fc_programs(tfluid)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "m")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main)
        before = _tree(d)
        scope.set("w", scope.get("w") + 1)

        def boom(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(tio, "_write_manifest", boom)
        with pytest.raises(OSError, match="disk full"):
            tfluid.io.save_inference_model(d, ["x"], [out], exe,
                                           main_program=main)
    assert _tree(d) == before
    assert sorted(os.listdir(str(tmp_path))) == ["m"]


def test_aot_and_sharded_entry_points_raise(tmp_path):
    main, startup, out = _fc_programs(tfluid)
    exe = _cpu()
    with pytest.raises(NotImplementedError, match="item 11"):
        tfluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [out],
                                       exe, main_program=main,
                                       aot_example_inputs={"x": None})
    for fn in (tio.save_sharded_checkpoint, tio.load_sharded_checkpoint):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn(exe, str(tmp_path / "c"))
    # fluid.io.PyReader, which waited for item 9, is the layer's class now
    assert tio.PyReader is tfluid.layers.io.PyReader
    assert tio.PyReader(capacity=4)._capacity == 4


def _train_programs(dropout):
    with tfluid.unique_name.guard():
        return ttransformer.training_programs(
            7, **dict(SMALL_TRANSFORMER, dtype="float32",
                      dropout_rate=dropout))


def _steps(exe, main, loss, scope, n, seed):
    one = ttransformer.synthetic_batch(2, 16, 64, seed=seed)
    stacked = {k: np.stack([v] * n) for k, v in one.items()}
    return exe.run_steps(main, feed=stacked, n_steps=n, fetch_list=[loss],
                         scope=scope)[0]


def _persistables(main, scope):
    return {v.name: scope.get(v.name).clone() for v in main.list_vars()
            if tio._is_persistable(v) and scope.get(v.name) is not None}


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    main, startup, loss = _train_programs(0.1)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    _steps(exe, main, loss, scope, 2, seed=0)
    ckpt = str(tmp_path / "ckpt")
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main, step=2)
    saved = _persistables(main, scope)
    states = {k: g.get_state() for k, g in scope._generators.items()}
    run_a = _steps(exe, main, loss, scope, 2, seed=1)

    resumed = tfluid.Scope()
    with tfluid.scope_guard(resumed):
        meta = tfluid.io.load_checkpoint(exe, ckpt, main)
    assert meta["step"] == 2
    for name, value in saved.items():
        assert torch.equal(resumed.get(name), value), name
    assert set(resumed._generators) == set(states)
    for key, state in states.items():
        assert torch.equal(resumed._generators[key].get_state(), state)
    run_b = _steps(exe, main, loss, resumed, 2, seed=1)
    np.testing.assert_array_equal(run_b, run_a)

    # control: the same persistables without the random streams
    control = tfluid.Scope()
    with tfluid.scope_guard(control):
        tfluid.io.load_checkpoint(exe, ckpt, main)
    control._generators.clear()
    assert not np.array_equal(_steps(exe, main, loss, control, 2, seed=1),
                              run_a)


def test_checkpoint_falls_back_to_old(tmp_path):
    main, startup, loss = _train_programs(0.0)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    ckpt = str(tmp_path / "ckpt")
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main, step=1)
        tfluid.io.save_checkpoint(exe, ckpt, main, step=2)
        # a crash between the swap's two renames leaves only .old
        os.rename(ckpt, ckpt + ".old")
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 2
        # the next save rescues it as .old.keep, then swaps in
        tfluid.io.save_checkpoint(exe, ckpt, main, step=3)
        assert tfluid.io.load_checkpoint(exe, ckpt, main)["step"] == 3
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt"]
    assert tfluid.io.load_checkpoint(exe, str(tmp_path / "none"), main) == {}


def test_cuda_stream_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = {"torch_generators": [{"fp": "relu>x", "device": "cuda:0",
                                  "state": ""}]}
    with pytest.raises(RuntimeError, match="relu>x"):
        tio._rng_state_from_meta(tfluid.Scope(), meta)


def test_jax_checkpoint_rng_keys_warn(tmp_path):
    """A JAX checkpoint loads its persistables into the port; its threefry
    keys cannot seed torch streams and are named in a warning."""
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstartup):
        x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
        jfluid.layers.dropout(jfluid.layers.fc(input=x, size=3), 0.5)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    ckpt = str(tmp_path / "ckpt")
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        jexe.run(jmain, feed={"x": np.ones((2, 4), "float32")})
        jfluid.io.save_checkpoint(jexe, ckpt, jmain)
    with open(os.path.join(ckpt, "__meta__.json")) as f:
        assert "rng_keys" in json.load(f)
    tmain, tstartup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(tmain, tstartup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        tfluid.layers.dropout(tfluid.layers.fc(input=x, size=3), 0.5)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope), \
            pytest.warns(UserWarning, match="rng_keys"):
        tfluid.io.load_checkpoint(_cpu(), ckpt, tmain)
    assert not tscope._generators
    np.testing.assert_array_equal(tscope.get("fc_0.w_0").numpy(),
                                  np.asarray(jscope.get("fc_0.w_0")))


def test_save_and_load_host_ops(tmp_path):
    main, startup, _ = _fc_programs(tfluid)
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    path = str(tmp_path / "sub" / "w")
    saver = tfluid.Program()
    saver.global_block().append_op(type="save", inputs={"X": ["w"]},
                                   attrs={"file_path": path})
    exe.run(saver, scope=scope)
    assert os.listdir(str(tmp_path / "sub")) == ["w.bf16.npy"]
    loader = tfluid.Program()
    with tfluid.program_guard(loader):
        out = loader.global_block().create_var(name="w2", shape=[6, 8],
                                               dtype="bfloat16")
        tfluid.layers.load(out, path)
    got, = exe.run(loader, fetch_list=["w2"], scope=scope,
                   return_numpy=False)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, scope.get("w")) and torch.equal(
        scope.get("w2"), scope.get("w"))
