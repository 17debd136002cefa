"""The port's BERT (paddle_tpu_torch.models.bert) against the JAX package's
on the CPU, at a small size: 2 layers, d_model 128, 4 heads (D 32, H*D
128), d_ff 256, seq 16, vocab 1,000, batch 2.

Both packages build bench.py's BERT leg (the model, Adam(1e-4).minimize):
the programs must be op-for-op identical, startup included. With the JAX
package's parameters and optimizer state carried over by
params_from_numpy, both executors must give the same loss and gradients
after one step and the same losses and parameters over three run_steps
steps, at tests/test_torch_backward.py's tolerances: float32, the loss to
1e-5 relative, each gradient to 1e-4 of its largest magnitude plus 1e-7
(the k-projection biases' true gradient is 0: both return noise), the
parameters to 1e-5 absolute at lr 1e-4; bfloat16, the loss to 1e-3
relative and each gradient but the k biases' to 0.1 in norm. Dropout is 0
where values are compared: the port draws masks from Philox, the JAX
package from threefry. Inputs come from seeded numpy.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import bert as tbert

SMALL = dict(n_layer=2, d_model=128, n_head=4, d_ff=256, seq_len=16,
             vocab_size=1000, dropout_rate=0.0)
LR = 1e-4


def _build(fluid, bert, **cfg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss = bert.build(**dict(SMALL, **cfg))
        fluid.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


@pytest.mark.parametrize("cfg", [{}, {"dtype": "bfloat16"},
                                 {"dropout_rate": 0.1}],
                         ids=["f32", "bf16", "dropout"])
def test_training_programs_are_op_for_op_identical(cfg):
    jm, js, _ = _build(jfluid, jbert, **cfg)
    tm, ts, _ = _build(tfluid, tbert, **cfg)
    for jp, tp in ((jm, tm), (js, ts)):
        assert _signature(jp) == _signature(tp)
    types = [op.type for op in tm.global_block().ops]
    for t in ("gelu", "tanh", "one_hot", "slice", "fused_attention"):
        assert t in types
    assert ("cast" in types) == (cfg.get("dtype") == "bfloat16")
    assert types.count("adam") == len(tm.all_parameters())


def test_training_programs_helper_is_the_bench_leg():
    with tfluid.unique_name.guard():
        main, startup, loss = tbert.training_programs(7, **SMALL)
    tm, ts, tloss = _build(tfluid, tbert)
    assert startup.random_seed == 7 and loss.name == tloss.name
    assert _signature(main) == _signature(tm)
    assert _signature(startup) == _signature(ts)


@pytest.mark.parametrize("kw", [{"strategy": object()},
                                {"pipeline_stages": True}])
def test_unported_options_raise(kw):
    with tfluid.unique_name.guard(), tfluid.program_guard(tfluid.Program(),
                                                          tfluid.Program()):
        with pytest.raises(NotImplementedError):
            tbert.build(**dict(SMALL, **kw))


def _pair(cfg):
    jm, js, jloss = _build(jfluid, jbert, **cfg)
    tm, ts, tloss = _build(tfluid, tbert, **cfg)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [v.name for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    return (jm, jexe, jscope, jloss), (tm, texe, tscope, tloss), names


def _f32(x):
    return np.asarray(texecutor.as_numpy(x), dtype=np.float32)


def _batch(seed):
    return jbert.synthetic_batch(2, SMALL["seq_len"], SMALL["vocab_size"],
                                 seed=seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_loss_and_gradients_match_jax_executor(dtype):
    j, t, _ = _pair({"dtype": dtype})
    grads = [p.name + "@GRAD" for p in j[0].all_parameters()]
    want = j[1].run(j[0], feed=_batch(0), fetch_list=[j[3].name] + grads,
                    scope=j[2])
    got = t[1].run(t[0], feed=_batch(0), fetch_list=[t[3].name] + grads,
                   scope=t[2])
    want, got = [_f32(w) for w in want], [_f32(g) for g in got]
    assert got[0].shape == ()
    rel = 1e-5 if dtype == "float32" else 1e-3
    assert abs(got[0] - want[0]) <= rel * want[0]
    for name, w, g in zip(grads, want[1:], got[1:]):
        assert g.shape == w.shape, name
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, \
                name
        elif ".k.b@" not in name:    # true gradient 0: both are noise
            assert np.linalg.norm(g - w) <= 0.1 * np.linalg.norm(w), name


def test_three_run_steps_match_jax_parameters():
    j, t, names = _pair({})
    steps = [_batch(seed) for seed in (1, 2, 3)]
    stacked = {n: np.stack([s[n] for s in steps]) for n in steps[0]}
    want, = j[1].run_steps(j[0], feed=stacked, n_steps=3,
                           fetch_list=[j[3].name], scope=j[2])
    got, = t[1].run_steps(t[0], feed=stacked, n_steps=3,
                          fetch_list=[t[3].name], scope=t[2])
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = {p.name for p in j[0].all_parameters()}
    for n in names:
        w, g = _f32(j[2].get(n)), _f32(t[2].get(n))
        if n in params:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=n)
        elif "pow_acc" in n:      # beta powers: b^4 after startup + 3 steps
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=n)


def test_bert_base_kernel_gates_match_jax():
    """bench.py's BERT-base program (BERT_BASE_CFG, batch 256): what each
    kernel gate admits, by the port's gates and by the JAX package's, and so
    the launches a training step makes on the card: 12 one-pass attention
    forwards and backwards (T 128, D 64), 74 Adam parameters in
    ceil(74 / 72) = 2 launches, with FLAGS_ln_kernel 25 LayerNorm backwards
    on [32768, 768], and no cross-entropy (V 30,522 and 2) or
    embedding-grad kernel ([30522, 768] and [2, 768])."""
    from paddle_tpu.ops import adam_kernel as jadam
    from paddle_tpu.ops import ce_kernel as jce
    from paddle_tpu.ops import emb_grad_kernel as jeg
    from paddle_tpu.ops import layernorm_kernel as jln
    from paddle_tpu_torch.ops import adam_kernel as tadam
    from paddle_tpu_torch.ops import attention as tattn
    from paddle_tpu_torch.ops import ce_kernel as tce
    from paddle_tpu_torch.ops import emb_grad_kernel as teg
    from paddle_tpu_torch.ops import layernorm_kernel as tln
    cfg = tbert.BERT_BASE_CFG
    batch, t = tbert.BERT_BASE_BATCH, cfg["seq_len"]
    with tfluid.unique_name.guard():
        main, _, loss = tbert.training_programs(0, **cfg)
    block = main.global_block()
    ops = block.ops
    shape = lambda name: block.var(name).shape

    attn = [op for op in ops if op.type == "fused_attention"]
    qkv = torch.empty(batch, t, cfg["n_head"], cfg["d_model"] // cfg["n_head"],
                      device="meta")
    assert len(attn) == cfg["n_layer"] and qkv.shape[-1] == 64
    assert tattn._onepass_ok(qkv, qkv)

    params = main.all_parameters()
    admitted = [p.name for p in params if tadam.adam_ok(p.shape)]
    assert admitted == [p.name for p in params if jadam.adam_ok(p.shape)]
    assert len(admitted) == 74
    assert math.ceil(len(admitted) / tadam._MAX_TENSORS) == 2
    plan = texecutor._Plan(main, [loss.name])
    adam = [k for k, (op, _) in enumerate(plan.steps) if op.type == "adam"]
    assert len(adam) == 204 and list(plan.runs.values()) == [adam]

    ln = [op for op in ops if op.type == "layer_norm"]
    assert len(ln) == 2 * cfg["n_layer"] + 1
    rows = batch * t
    assert tln.ln_bwd_ok(rows, cfg["d_model"])
    assert jln.ln_bwd_ok(rows, cfg["d_model"])

    ce = [op for op in ops if op.type == "softmax_with_cross_entropy"]
    for op in ce:
        lead = [batch if s < 0 else s for s in shape(op.input("Logits")[0])]
        tokens, v = math.prod(lead[:-1]), lead[-1]
        assert not tce.ce_ok(tokens, v, 2) and not jce.ce_ok(tokens, v, 2)
    assert sorted(lead[-1] for lead in
                  (shape(op.input("Logits")[0]) for op in ce)) == [2, 30522]

    tables = {op.input("W")[0]: op for op in ops if op.type == "lookup_table"}
    assert sorted(tables) == ["seg_emb", "word_emb"]
    for name in tables:
        for impl in ("scatter", "segsum"):
            args = (shape(name), rows, impl)
            assert not teg.emb_grad_ok(*args, dtype=torch.bfloat16)
            assert not jeg.emb_grad_ok(*args, dtype=jnp.bfloat16)
