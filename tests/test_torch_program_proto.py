"""The port's ProgramDesc serialization (paddle_tpu_torch/fluid/proto/)
against the JAX package's, on the CPU.

- The wire codec round-trips every field type.
- The port's ``Program.serialize_to_string()`` is byte for byte the JAX
  package's, main and startup, for bench.py's programs at their real
  widths: ResNet-50 (the bench leg, bf16 with Momentum, and is_test), the
  flagship Transformer (training with Adam, and serving), BERT-base and
  DeepFM. No weights are made: building the programs is enough.
- ``parse_from_string`` of the JAX package's bytes gives the port the same
  program, and the JSON debug form round-trips.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.proto import program_desc, wire
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer


def _transformer_train(fluid, m):
    _, loss = m.build(**ttransformer.FLAGSHIP_CFG)
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)


def _transformer_serve(fluid, m):
    m.build(is_test=True, **ttransformer.FLAGSHIP_CFG)


def _resnet_bench(fluid, m):
    _, loss, _ = m.build(dataset="flowers", dtype="bfloat16")
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)


def _resnet_test(fluid, m):
    m.build(dataset="flowers", is_test=True)


def _bert(fluid, m):
    _, loss = m.build(**dict(tbert.BERT_BASE_CFG, dtype="bfloat16"))
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)


def _deepfm(fluid, m):
    _, loss, _ = m.build(**tdeepfm.DEEPFM_BENCH_CFG)
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)


PROGRAMS = {
    "resnet50_bench": (_resnet_bench, jresnet, tresnet),
    "resnet50_is_test": (_resnet_test, jresnet, tresnet),
    "transformer_train": (_transformer_train, jtransformer, ttransformer),
    "transformer_serve": (_transformer_serve, jtransformer, ttransformer),
    "bert_base": (_bert, jbert, tbert),
    "deepfm": (_deepfm, jdeepfm, tdeepfm),
}


def _programs(name, port):
    build, jm, tm = PROGRAMS[name]
    fluid, model = (tfluid, tm) if port else (jfluid, jm)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        build(fluid, model)
    return main, startup


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


SCHEMA = wire.Schema("T", [
    (1, "i", "opt", "int32"), (2, "l", "opt", "int64"),
    (3, "u", "opt", "uint64"), (4, "b", "opt", "bool"),
    (5, "e", "opt", "enum"), (6, "f", "opt", "float"),
    (7, "s", "opt", "string"), (8, "y", "opt", "bytes"),
    (9, "ri", "rep", "int64"), (10, "rs", "rep", "string"),
    (11, "sub", "rep", wire.Schema("S", [(1, "x", "req", "int32")])),
])


def test_wire_round_trip():
    msg = {"i": -7, "l": -(1 << 40), "u": (1 << 63) + 5, "b": True, "e": 22,
           "f": 0.5, "s": "fc_0.w_0", "y": b"\x00\xff", "ri": [0, -1, 1 << 35],
           "rs": ["a", ""], "sub": [{"x": 1}, {"x": -2}]}
    assert wire.decode(SCHEMA, wire.encode(SCHEMA, msg)) == msg
    with pytest.raises(ValueError, match="required"):
        wire.encode(SCHEMA, {"sub": [{}]})


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_serialize_to_string_is_the_jax_packages_bytes(name):
    jmain, jstartup = _programs(name, port=False)
    tmain, tstartup = _programs(name, port=True)
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        tbytes = tp.serialize_to_string()
        assert tbytes == jp.serialize_to_string()
        # the JAX package's bytes parse into the port's IR unchanged
        parsed = tfluid.Program.parse_from_string(jp.serialize_to_string())
        assert parsed.serialize_to_string() == tbytes
        # as in the JAX package, the proto form has no Parameter flag
        assert not parsed.all_parameters()
        assert [v.name for v in parsed.list_vars()] == \
            [v.name for v in tp.list_vars()]


def test_parse_from_string_gives_the_jax_programs_signature():
    """Parsed from the JAX package's bytes, the port's program has the JAX
    parse's signature (ops, attrs, vars)."""
    jmain, _ = _programs("resnet50_is_test", port=False)
    data = jmain.serialize_to_string()
    assert _signature(tfluid.Program.parse_from_string(data)) == \
        _signature(jfluid.Program.parse_from_string(data))


def test_json_debug_form_round_trips():
    tmain, _ = _programs("transformer_train", port=True)
    text = tmain.serialize_to_json()
    assert text[:1] == b"{"
    back = tfluid.Program.parse_from_string(text)
    assert _signature(back) == _signature(tmain)
    assert back.serialize_to_string() == tmain.serialize_to_string()
    assert tfluid.Program.parse_from_string(text.decode()).to_dict() == \
        tmain.to_dict()


def test_ndarray_and_long_attrs_round_trip():
    p = tfluid.Program()
    table = np.arange(6, dtype="float32").reshape(2, 3)
    p.global_block().append_op(
        type="assign_value", outputs={"Out": ["x"]},
        attrs={"values": table, "big": 1 << 40, "flag": True,
               "mixed": [1, 2.5], "nested": {"a": [1, 2]}})
    op = tfluid.Program.parse_from_string(
        p.serialize_to_string()).global_block().ops[0]
    np.testing.assert_array_equal(op.attr("values"), table)
    assert op.attr("big") == 1 << 40 and op.attr("flag") is True
    assert op.attr("mixed") == [1.0, 2.5] and op.attr("nested") == {"a": [1, 2]}


@pytest.mark.parametrize("value", [
    pytest.param(lambda torch: torch.tensor(3), id="tensor"),
    pytest.param(lambda torch: torch.Size([2, 3]), id="size"),
    pytest.param(lambda torch: [torch.tensor(1.0)], id="list")])
def test_torch_values_never_reach_an_attr(value):
    import torch
    with pytest.raises(TypeError, match="torch value"):
        program_desc._attr_to_pb("shape", value(torch))


def test_mutations_bump_the_version():
    p = tfluid.Program()
    b = p.global_block()
    v = p.version
    b.append_op(type="relu", inputs={"X": ["a"]}, outputs={"Out": ["b"]})
    b.prepend_op(type="feed", inputs={"X": ["feed"]}, outputs={"Out": ["a"]})
    b.insert_op(1, type="scale", inputs={"X": ["a"]}, outputs={"Out": ["c"]})
    assert [op.type for op in b.ops] == ["feed", "scale", "relu"]
    b.remove_op(1)
    assert [op.type for op in b.ops] == ["feed", "relu"]
    assert p.version == v + 4
