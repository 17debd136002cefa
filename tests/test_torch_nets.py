"""``fluid.nets``, ``fc`` over several inputs, the ``fused_attention`` op in
its default [B, H, T, D] layout and ``FLAGS_check_nan_inf`` on the port,
against the JAX package on the CPU.

Programs are op for op the JAX package's (types, inputs, outputs, attrs,
variables; startup too), and their values (outputs, the loss and every
@GRAD variable after append_backward, from the JAX startup state) agree
within 1e-5 of the largest JAX magnitude plus 1e-7 absolute (float32;
summation order only). bhtd attention: the port's dense route against the
JAX package's ``fused_attention`` to 1e-5; the flash route, forced on the
CPU where its wrappers run their plain versions, to the same bound, and
equal bit for bit to the [B, T, H, D] route on the transposed tensors (the
same functions on the same values).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.ops import attention as JA
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.ops import attention as TA

from test_torch_gradients import _data, _feed, _programs, _run_both
import torch_resnet_step as step

TOL = 1e-5


def _grads_of(build):
    """build(fluid) -> (output, loss); append_backward over the loss. The
    fetch: the output, the loss and every @GRAD variable."""
    def full(fluid):
        out, loss = build(fluid)
        fluid.backward.append_backward(loss)
        return out, loss

    def fetch(res):
        block = res[0].block
        return [res[0].name, res[1].name] + sorted(
            n for n in block.vars if n.endswith("@GRAD"))
    return full, fetch


# --------------------------------------------------------------------------
# fc over several inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("attrs", [None, ["wa", "wb", "wc"]],
                         ids=["default", "per_input_param_attr"])
def test_fc_over_several_inputs(attrs):
    """fc([a, b, c]): one mul per input (its own weight, named by the
    per-input param_attr list where given), one sum op, the bias, the
    activation."""
    def build(fluid):
        L = fluid.layers
        xs = [_data(L, n, [w]) for n, w in zip("abc", (5, 3, 7))]
        h = L.fc(xs, 4, act="tanh", param_attr=attrs)
        return h, L.mean(L.square(h))

    full, fetch = _grads_of(build)
    _, _, tm, _ = _run_both(full, _feed("abc", [[5], [3], [7]], batch=6),
                            fetch)
    ops = tm.global_block().ops
    types = [op.type for op in ops]
    assert types[:6] == ["mul", "mul", "mul", "sum", "elementwise_add",
                         "tanh"]
    weights = [op.input("Y")[0] for op in ops[:3]]
    assert weights == (attrs or ["fc_0.w_0", "fc_0.w_1", "fc_0.w_2"])
    assert [tm.global_block().var(w).shape for w in weights] == \
        [(5, 4), (3, 4), (7, 4)]


# --------------------------------------------------------------------------
# fused_attention in [B, H, T, D]
# --------------------------------------------------------------------------

def _qkv(seed, b=2, h=2, t=32, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype("float32") for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_bhtd_op_matches_jax(causal):
    """The op with layout bhtd (the default) in a program: out and the
    gradients of q, k and v against the JAX executor's."""
    def build(fluid):
        L = fluid.layers
        q, k, v = (_data(L, n, [2, 32, 8]) for n in "qkv")
        helper = fluid.LayerHelper("fused_attention")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="fused_attention",
                         inputs={"Q": [q], "K": [k], "V": [v]},
                         outputs={"Out": [out]},
                         attrs={"causal": causal, "scale": -1.0})
        return out, L.mean(L.square(out))

    full, fetch = _grads_of(build)
    feed = dict(zip("qkv", _qkv(3)))
    want, got, tm, _ = _run_both(full, feed, fetch)
    assert {"q@GRAD", "k@GRAD", "v@GRAD"} <= set(got)


def _jax_vjp(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda a, b, c: JA.fused_attention(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, causal, fn=TA.fused_attention, tr=False):
    f = (lambda a: torch.from_numpy(a).transpose(1, 2).contiguous()) \
        if tr else torch.from_numpy
    leaves = [f(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, f(do))
    back = (lambda t: t.transpose(1, 2)) if tr else (lambda t: t)
    return [back(t).detach() for t in (out,) + tuple(grads)]


@pytest.mark.parametrize("causal", [False, True])
def test_bhtd_dense_route_matches_jax(causal):
    """Off the card: reference_attention, forward and vjp."""
    q, k, v, do = _qkv(5) + [_qkv(6)[0]]
    for got, want in zip(_port(q, k, v, do, causal),
                         _jax_vjp(q, k, v, do, causal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture
def on_card(monkeypatch):
    """The card's dispatch on CPU tensors: the kernel wrappers then run
    their plain versions. Records the flash forward's calls."""
    calls = []
    fwd = TA.flash_attention_fwd_bthd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fwd(*a, **kw)
    monkeypatch.setattr(TA, "_use_kernels", lambda q: True)
    monkeypatch.setattr(TA, "flash_attention_fwd_bthd", counted)
    monkeypatch.setenv("FLAGS_flash_min_seq", "32")
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_bhtd_flash_route_equals_the_bthd_route(on_card, causal):
    """T_k >= FLAGS_flash_min_seq on the card: the flash forward on the
    transposed tensors, dq and dkv in the backward; out and the three
    gradients equal the bthd route's on the transposed tensors bit for bit,
    and the JAX package's within 1e-5. Below the threshold the dense
    route runs (no flash call), as the JAX package's bhtd route never takes
    the one-pass kernel."""
    q, k, v, do = _qkv(7) + [_qkv(8)[0]]
    got = _port(q, k, v, do, causal)
    assert on_card == [(2, 32, 2, 8)]
    assert TA._bthd_mode(*[torch.empty(2, 32, 2, 8)] * 2) == TA._MODE_FLASH
    bthd = _port(q, k, v, do, causal, TA.fused_attention_bthd, tr=True)
    for g, b in zip(got, bthd):
        assert torch.equal(g, b)
    for g, w in zip(got, _jax_vjp(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    short = [a[:, :, :16] for a in (q, k, v, do)]
    calls = len(on_card)
    dense = _port(*short, causal)
    assert len(on_card) == calls
    for g, w in zip(dense, _jax_vjp(*short, causal)):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# fluid.nets
# --------------------------------------------------------------------------

def _img(fluid):
    return _data(fluid.layers, "img", [3, 12, 12])


# gradients that are 0 in exact arithmetic: a conv bias followed by a
# batch norm (the norm subtracts it again)
ZERO_GRADS = {"img_conv_group": ["conv2d_0.b_0@GRAD", "conv2d_1.b_0@GRAD"]}

NETS = {
    "simple_img_conv_pool": lambda fl: fl.nets.simple_img_conv_pool(
        _img(fl), num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
        act="relu"),
    "img_conv_group": lambda fl: fl.nets.img_conv_group(
        _img(fl), conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
        conv_with_batchnorm=True, pool_stride=2),
    "img_conv_group_plain": lambda fl: fl.nets.img_conv_group(
        _img(fl), conv_num_filter=[4, 5], pool_size=2, conv_act="relu",
        pool_stride=2),
    "glu": lambda fl: fl.nets.glu(_data(fl.layers, "x", [6, 8]), dim=1),
    "scaled_dot_product_attention":
        lambda fl: fl.nets.scaled_dot_product_attention(
            *(fl.layers.fc(_data(fl.layers, "x", [5, 8]), 8,
                           num_flatten_dims=2) for _ in range(3)),
            num_heads=2),
}
NET_FEEDS = {"simple_img_conv_pool": ("img", [3, 12, 12]),
             "img_conv_group": ("img", [3, 12, 12]),
             "img_conv_group_plain": ("img", [3, 12, 12]),
             "glu": ("x", [6, 8]),
             "scaled_dot_product_attention": ("x", [5, 8])}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_jax(name):
    """Each net on a small input: op for op, and its output, the loss
    (mean of squares) and every gradient against the JAX executor's."""
    def build(fluid):
        out = NETS[name](fluid)
        return out, fluid.layers.mean(fluid.layers.square(out))

    full, fetch = _grads_of(build)
    feed_name, shape = NET_FEEDS[name]
    _run_both(full, _feed([feed_name], [shape], batch=4), fetch,
              zero=ZERO_GRADS.get(name, ()))


@pytest.mark.parametrize("name", ["img_conv_group",
                                  "scaled_dot_product_attention"])
def test_net_with_dropout_is_op_for_op(name):
    """The nets' dropout options (drawn differently in the two packages):
    the programs only."""
    def build(fluid):
        if name == "img_conv_group":
            return fluid.nets.img_conv_group(
                _img(fluid), conv_num_filter=[4, 4], pool_size=2,
                conv_act="relu", conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=[0.1, 0.0])
        x = _data(fluid.layers, "x", [5, 8])
        return fluid.nets.scaled_dot_product_attention(x, x, x, 2, 0.1)

    jm, js, _ = _programs(jfluid, build)
    tm, ts, _ = _programs(tfluid, build)
    assert step.signature(jm) == step.signature(tm)
    assert step.signature(js) == step.signature(ts)
    assert "dropout" in [op.type for op in tm.global_block().ops]


def test_nets_surface():
    assert tfluid.nets.__all__ == jfluid.nets.__all__
    with pytest.raises(NotImplementedError, match="item 4"):
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            tfluid.nets.sequence_conv_pool(_img(tfluid), 4, 3)
    with pytest.raises(ValueError, match="divisible"):
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            x = _data(tfluid.layers, "x", [5, 8])
            tfluid.nets.scaled_dot_product_attention(x, x, x, num_heads=3)


# --------------------------------------------------------------------------
# FLAGS_check_nan_inf and the flags
# --------------------------------------------------------------------------

def _log_program(fluid, state=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.log(x)  # log of negative -> nan
        if state:
            s = main.global_block().create_var(
                name="state", shape=[-1, 4], dtype="float32",
                persistable=True)
            main.global_block().append_op(
                type="scale", inputs={"X": [out]}, outputs={"Out": [s]},
                attrs={"scale": 2.0})
            out = fluid.layers.relu(x)
    return main, out


def test_nan_check():
    """tests/test_aux.py::test_nan_check on the port: set by hand, the
    check raises naming the variable; with the flag off the run returns
    NaN."""
    main, out = _log_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": -np.ones((2, 4), "float32")}
    assert exe.check_nan_inf is False
    with tfluid.scope_guard(tfluid.Scope()):
        got, = exe.run(main, feed=feed, fetch_list=[out])
        assert np.isnan(got).all()
        exe.check_nan_inf = True
        with pytest.raises(FloatingPointError, match=repr(out.name)):
            exe.run(main, feed=feed, fetch_list=[out])
        got, = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                       fetch_list=[out])
        assert (got == 0).all()


def test_nan_check_reads_the_flag_and_scans_scope_writes(monkeypatch):
    """FLAGS_check_nan_inf=1 turns the check on; a non-finite value the run
    writes to a persistable raises though every fetch is finite; a finite
    tensor whose sum of |x| overflows is not reported."""
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert exe.check_nan_inf is True
    main, out = _log_program(tfluid, state=True)
    with tfluid.scope_guard(tfluid.Scope()):
        with pytest.raises(FloatingPointError, match="'state'"):
            exe.run(main, feed={"x": -np.ones((2, 4), "float32")},
                    fetch_list=[out])
        big = np.full((2, 4), 3e38, "float32")
        got, = exe.run(main, feed={"x": big}, fetch_list=[out])
        assert np.isfinite(got).all()


def test_nan_check_names_the_first_in_program_order():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        a = tfluid.layers.log(x)
        b = tfluid.layers.sqrt(x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.check_nan_inf = True
    with pytest.raises(FloatingPointError, match=repr(a.name)):
        exe.run(main, feed={"x": -np.ones((2, 4), "float32")},
                fetch_list=[b, a], scope=tfluid.Scope())


def test_flags_table_and_dump():
    """check_nan_inf and the three compatibility no-ops carry the JAX
    package's names, types and defaults; dump() prints every flag."""
    for name in ("check_nan_inf", "fraction_of_gpu_memory_to_use",
                 "benchmark", "eager_delete_tensor_gb"):
        assert tflags.WHITELIST[name][:2] == jflags.WHITELIST[name][:2]
    for name in ("rng_impl", "dropout_rng", "profiler_max_events",
                 "monitor_port"):
        assert name not in tflags.WHITELIST
    lines = tflags.dump().splitlines()
    assert len(lines) == len(tflags.WHITELIST)
    assert "FLAGS_check_nan_inf=False (default False)" in tflags.dump()
