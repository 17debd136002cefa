"""The port's ResNet (paddle_tpu_torch.models.resnet) against the JAX
package's on the CPU: bench.py's ResNet-50 training program op for op, the
executor's plan of it, and float32 training steps (tests/torch_resnet_step.py
has the models: resnet_imagenet(depth=50) at 3x64x64, batch 4, 10 classes,
and resnet_cifar10(depth=8) at 3x32x32; tests/test_torch_resnet_bf16.py
holds bfloat16).

- Op by op ("teacher-forced"): each output of every op of the port's step,
  run on the JAX step's values for its inputs, within 1e-4 of the output's
  largest JAX magnitude. Sound reading 1.8e-5 (batch_norm's E[x^2] -
  E[x]^2 cancels where a channel's mean is a few times its spread).
  Control: the running variance updated with the unbiased estimate, as
  F.batch_norm does (n / (n - 1), n = 16 values a channel), which moves
  VarianceOut by more.
- End to end: the port's executor runs the whole step from the same state.
  resnet_cifar10(depth=8) agrees as closely as op by op (sound reading
  1e-5 of the largest value). ResNet-50 at random init amplifies rounding
  through its fifty layers: a 1e-7 relative change of the input alone
  moves the port's own gradients by up to 35% of their largest value and
  3.8% in norm. So its loss is held to 5e-4 relative (sound reading
  4.5e-5) and every gradient and persistable after the step to 0.25 in
  norm (sound reading 0.09); the control, the is_test program (running
  statistics in place of the batch's), misses both by three orders of
  magnitude.

Three run_steps steps of resnet_cifar10(depth=8) agree to its one-step
bounds.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.ops import nn_ops, registry
from paddle_tpu_torch.models import resnet as tresnet

import torch_resnet_step as step


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


def _bench_leg(fluid, resnet):
    """bench.py's build_resnet50 in fresh programs."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss, acc = resnet.build(dataset="flowers", dtype="bfloat16")
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss, acc


def test_bench_leg_is_op_for_op_the_jax_packages():
    jm, js, _, _ = _bench_leg(jfluid, jresnet)
    tm, ts, _, _ = _bench_leg(tfluid, tresnet)
    assert _signature(jm) == _signature(tm)
    assert _signature(js) == _signature(ts)
    types = [op.type for op in tm.global_block().ops]
    assert len(types) == 538 and len(ts.global_block().ops) == 429
    counts = {t: types.count(t) for t in set(types)}
    assert counts == {
        "cast": 2, "conv2d": 53, "batch_norm": 53, "relu": 49, "pool2d": 2,
        "elementwise_add": 17, "mul": 1, "softmax_with_cross_entropy": 1,
        "mean": 1, "softmax": 1, "top_k": 1, "accuracy": 1,
        "fill_constant": 1, "grad_of": 124,
        "softmax_with_cross_entropy_grad": 1, "batch_norm_grad": 53,
        "sum": 16, "momentum": 161}
    params = tm.all_parameters()
    assert len(params) == 267
    assert sum(int(np.prod(p.shape)) for p in params) == 25610152
    trainable = [p for p in params if p.trainable]
    assert len(trainable) == 161
    assert sum(p.dtype == "bfloat16" for p in params) == 55
    velocities = [v for v in tm.global_block().vars.values()
                  if "_velocity_acc_" in v.name]
    assert len(velocities) == 161 and {v.dtype for v in velocities} == \
        {"float32"}


def test_training_programs_helper_is_the_bench_leg():
    with tfluid.unique_name.guard():
        main, startup, loss, acc = tresnet.training_programs(
            5, dataset="flowers", dtype=tresnet.RESNET_BENCH_DTYPE)
    tm, ts, tloss, tacc = _bench_leg(tfluid, tresnet)
    assert startup.random_seed == 5
    assert (loss.name, acc.name) == (tloss.name, tacc.name)
    assert _signature(main) == _signature(tm)
    assert _signature(startup) == _signature(ts)
    feed = tresnet.synthetic_batch(tresnet.RESNET_BENCH_BATCH, [3, 224, 224],
                                   1000)
    assert feed["img"].shape == (64, 3, 224, 224)
    assert feed["label"].dtype == np.int64 and feed["label"].max() < 1000


def test_plan_pairs_every_batch_norm_grad_and_groups_the_momentum_ops():
    """The executor runs each batch_norm once: every batch_norm_grad reads
    the statistics of the batch_norm with its inputs, and the 161 momentum
    ops run as one group."""
    tm, _, loss, _ = _bench_leg(tfluid, tresnet)
    plan = texecutor._Plan(tm, [loss.name])
    steps = [op for op, _ in plan.steps]
    bn_grads = [k for k, op in enumerate(steps)
                if op.type == "batch_norm_grad"]
    assert len(bn_grads) == 53
    for k in bn_grads:
        fwd = steps[plan.grad_fwd[k]]
        assert fwd.type == "batch_norm" and fwd.input("X") == \
            steps[k].input("X")
        assert plan.taped[plan.grad_fwd[k]] == {}
    momentum = [k for k, op in enumerate(steps) if op.type == "momentum"]
    assert list(plan.runs.values()) == [momentum] and len(momentum) == 161


@pytest.mark.parametrize("model", sorted(step.MODELS))
def test_one_step_op_by_op_matches_jax_executor(model):
    step.assert_op_by_op(model, "float32")


def _unbiased_running_variance(lowering):
    """batch_norm whose VarianceOut takes the unbiased batch variance, as
    F.batch_norm updates it."""
    def fault(ctx, inputs, attrs):
        outs = lowering(ctx, inputs, attrs)
        x, var = inputs["X"][0], inputs["Variance"][0]
        m = attrs.get("momentum", 0.9)
        n = x.numel() // var.numel()
        bvar = (outs["VarianceOut"][0] - var * m) / (1.0 - m)
        outs["VarianceOut"] = [var * m + bvar * (n / (n - 1.0)) * (1.0 - m)]
        return outs
    return fault


def test_op_by_op_bound_rejects_the_unbiased_running_variance(monkeypatch):
    monkeypatch.setitem(registry._LOWERINGS, "batch_norm",
                        _unbiased_running_variance(nn_ops._batch_norm))
    with pytest.raises(AssertionError, match="batch_norm"):
        step.assert_op_by_op("resnet50", "float32")


# end to end: the loss relative, then the worst gradient and the worst
# persistable after the step by max over max and by norm (None: not held)
E2E_LIMITS = {"cifar8": {"loss": 1e-5, "grad_max": 1e-4, "grad_norm": 1e-4,
                         "state_max": 1e-4, "state_norm": 1e-4},
              "resnet50": {"loss": 5e-4, "grad_max": None, "grad_norm": 0.25,
                           "state_max": None, "state_norm": 0.25}}


def _within(errs, model):
    return all(lim is None or errs[k] <= lim
               for k, lim in E2E_LIMITS[model].items())


@pytest.mark.parametrize("model", sorted(step.MODELS))
def test_one_step_end_to_end_matches_jax_executor(model):
    errs = step.e2e_errors(model, *step.port_step(model))
    assert _within(errs, model), errs


def test_end_to_end_limits_reject_the_is_test_program():
    """The is_test program normalizes with the running statistics (0 and 1
    after startup), not the batch's: its step must fail the limits."""
    errs = step.e2e_errors("resnet50",
                           *step.port_step("resnet50", is_test=True))
    assert not _within(errs, "resnet50"), errs


def test_three_run_steps_match_jax_executor():
    """resnet_cifar10(depth=8): three steps through run_steps on three
    batches; the losses and every persistable after them within the
    one-step bounds."""
    model, lim = "cifar8", E2E_LIMITS["cifar8"]
    before, _, _ = step.jax_step(model, "float32")
    feeds = [step.feed(model, seed) for seed in (1, 2, 3)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    jm, js, jloss, _ = step.build(jfluid, jresnet, model, "float32")
    tm, ts, tloss, _ = step.build(tfluid, tresnet, model, "float32")
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    tfluid.params_from_numpy(before, tscope, "cpu")
    want, = jexe.run_steps(jm, feed=stacked, n_steps=3,
                           fetch_list=[jloss.name], scope=jscope)
    got, = texe.run_steps(tm, feed=stacked, n_steps=3,
                          fetch_list=[tloss.name], scope=tscope)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=lim["loss"])
    for n in before:
        w, g = step.f64(jscope.get(n)), step.f64(tscope.get(n))
        assert np.abs(g - w).max() <= lim["state_max"] * \
            (np.abs(w).max() or 1.0), n


def _profile_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_profile_serve.py")
    spec = importlib.util.spec_from_file_location("torch_profile_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,kind", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__"
     "5x_cudnn", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn",
     "conv"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_wo_smem_bf16bf16_bf16f32_f32_"
     "nhwckrsc_nhwc_tilesize128x64x64_stage4_warpsize2x2x1_g1_tensor16x8x16_"
     "execute_kernel__5x_cudnn", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>", "conv"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, true, false, (cudnnKernelDataType_t)0>", "conv"),
    ("void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, true, "
     "true, true, (cudnnKernelDataType_t)0>", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_64x64_64x5_nhwc_align8>", "conv"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
     "warpsize1x4x1_ffma_", "matmul"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4> >", "other")])
def test_profile_tool_puts_cudnn_convolutions_in_a_class_of_their_own(
        name, kind):
    """cuDNN's convolution kernels (fprop, dgrad, wgrad and its layout
    transforms) are "conv", ahead of the products, whose markers ("gemm",
    "xmma", "cutlass") some of them share."""
    assert _profile_tool()._kind(name) == kind
