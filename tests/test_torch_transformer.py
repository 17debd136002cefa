"""The flagship Transformer through the port (paddle_tpu_torch) against the
JAX package, on the CPU, at a small size.

Both packages build the same model; the Programs must be op-for-op
identical, and with the JAX parameters carried over by params_from_numpy
both executors must give the same logits and loss for the same request.
Tolerances, relative to max |logit|: 1e-4 in float32 (summation order
only); 3e-2 in bfloat16, where the two frameworks round bf16 products and
elementwise chains at different places (XLA fuses and keeps some
intermediates in f32) through every layer.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(n_layer=1, d_model=128, n_head=2, d_ff=256, seq_len=16,
             src_vocab=64, tgt_vocab=64, is_test=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(fluid, transformer, **cfg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss = transformer.build(**dict(SMALL, **cfg))
    return main, startup, loss


def _logits_name(main):
    op = [o for o in main.global_block().ops
          if o.type == "softmax_with_cross_entropy"][0]
    return op.input("Logits")[0]


def _prune(main):
    return main.clone(for_test=True)._prune(["src_ids", "tgt_ids"],
                                            [_logits_name(main)])


def _program_signature(program):
    """Op types, slots, attrs, and each var's name/shape/dtype/role."""
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.is_data,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


@pytest.mark.parametrize("cfg", [{}, {"dtype": "bfloat16"},
                                 {"use_fused_attention": False}],
                         ids=["f32", "bf16", "unfused"])
def test_programs_are_op_for_op_identical(cfg):
    jm, js, _ = _build(jfluid, jtransformer, **cfg)
    tm, ts, _ = _build(tfluid, ttransformer, **cfg)
    for jp, tp in ((jm, tm), (js, ts), (_prune(jm), _prune(tm))):
        jops, jvars = _program_signature(jp)
        tops, tvars = _program_signature(tp)
        assert len(jops) == len(tops)
        for a, b in zip(jops, tops):
            assert a == b
        assert jvars == tvars
    # the port's own pruning helper gives the same serving program
    tserve, logits = ttransformer.inference_program(
        tm, tm.global_block().var("mean_0.tmp_0"))
    assert logits == _logits_name(tm)
    assert _program_signature(tserve) == _program_signature(_prune(tm))


def _run_both(cfg, batch=2, seed=0):
    """Run the JAX package's startup, carry its parameters into the port,
    and answer one request (logits from the pruned program, loss from the
    test program) on both executors."""
    jm, js, jloss = _build(jfluid, jtransformer, **cfg)
    tm, ts, tloss = _build(tfluid, ttransformer, **cfg)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    params = {p.name: np.asarray(jscope.get(p.name))
              for p in jm.all_parameters()}
    tfluid.params_from_numpy(params, tscope, "cpu")
    b = jtransformer.synthetic_batch(batch, SMALL["seq_len"],
                                     SMALL["tgt_vocab"], seed)
    req = {"src_ids": b["src_ids"], "tgt_ids": b["tgt_ids"]}
    name = _logits_name(jm)
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    jl, = jexe.run(_prune(jm), feed=req, fetch_list=[name], scope=jscope)
    tl, = texe.run(_prune(tm), feed=req, fetch_list=[name], scope=tscope,
                   return_numpy=False)
    jloss_v, = jexe.run(jtest, feed=b, fetch_list=[jloss], scope=jscope)
    tloss_v, = texe.run(ttest, feed=b, fetch_list=[tloss], scope=tscope,
                        return_numpy=False)
    return jl, tl, jloss_v, tloss_v


@pytest.mark.parametrize("cfg,tol", [({}, 1e-4),
                                     ({"use_fused_attention": False}, 1e-4),
                                     ({"dtype": "bfloat16"}, 3e-2)],
                         ids=["f32", "unfused-f32", "bf16"])
def test_served_logits_and_loss_match_jax_executor(cfg, tol):
    jl, tl, jloss, tloss = _run_both(cfg)
    assert tfluid.core_types.convert_dtype(tl.dtype) == \
        tfluid.core_types.convert_dtype(jl.dtype)
    assert tfluid.core_types.convert_dtype(tloss.dtype) == \
        tfluid.core_types.convert_dtype(jloss.dtype)
    jl32 = np.asarray(jl, dtype=np.float32)
    tl32 = tl.float().numpy()
    assert tl32.shape == jl32.shape == (2, SMALL["seq_len"],
                                        SMALL["tgt_vocab"])
    scale = np.abs(jl32).max()
    assert np.abs(tl32 - jl32).max() <= tol * scale
    assert abs(float(tloss) - float(jloss)) <= tol * max(1.0, abs(float(jloss)))


def test_serving_programs_is_the_pruned_test_program():
    cfg = {k: v for k, v in SMALL.items() if k != "is_test"}
    with tfluid.unique_name.guard():
        serve, startup, logits = ttransformer.serving_programs(7, **cfg)
    tm, ts, _ = _build(tfluid, ttransformer)
    assert startup.random_seed == 7
    assert logits == _logits_name(tm)
    assert _program_signature(serve) == _program_signature(_prune(tm))
    assert _program_signature(startup) == _program_signature(ts)


def test_flagship_cfg_is_bench_cfg():
    """FLAGSHIP_CFG is bench.py's CFG (read from its source: importing
    bench.py sets process-wide flags)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    call = next(node.value for node in tree.body
                if isinstance(node, ast.Assign) and
                any(getattr(t, "id", None) == "CFG" for t in node.targets))
    cfg = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
    assert ttransformer.FLAGSHIP_CFG == cfg


def test_build_rejects_sharding_strategy():
    with pytest.raises(NotImplementedError):
        _build(tfluid, ttransformer, strategy=object())


def test_port_imports_no_jax():
    """The port, its models and its training modules load without JAX or
    the JAX package (a subprocess: this test process has both loaded)."""
    code = ("import sys, paddle_tpu_torch.fluid, "
            "paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.models.bert, "
            "paddle_tpu_torch.models.deepfm, "
            "paddle_tpu_torch.fluid.sparse_grads, "
            "paddle_tpu_torch.fluid.ops.metric_ops, "
            "paddle_tpu_torch.fluid.backward, "
            "paddle_tpu_torch.fluid.optimizer, "
            "paddle_tpu_torch.fluid.regularizer, "
            "paddle_tpu_torch.fluid.clip, "
            "paddle_tpu_torch.fluid.ops.grad_ops, "
            "paddle_tpu_torch.fluid.ops.optimizer_ops, "
            "paddle_tpu_torch.ops.attention, "
            "paddle_tpu_torch.ops.adam_kernel, "
            "paddle_tpu_torch.ops._build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paddle_tpu.')) or "
            "m == 'paddle_tpu')\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_profile_serve.py",
                                    "tools/torch_train_steps.py",
                                    "tools/torch_deepfm_lockstep.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts that run on the card (which has no JAX) import neither
    JAX nor the JAX package, at top level or inside a function."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert "paddle_tpu_torch.fluid" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib") or
           m == "paddle_tpu" or m.startswith("paddle_tpu.")]
    assert not bad, bad
