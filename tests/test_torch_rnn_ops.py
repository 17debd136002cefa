"""The recurrent lowerings (``paddle_tpu_torch/fluid/ops/rnn_ops.py``'s 8
besides ``recurrent``: dynamic_lstm, lstm, dynamic_gru, gru, lstmp,
cudnn_lstm, gru_unit, lstm_unit) and their six layers, each against the
JAX package on the same seeded numpy inputs, on the CPU.

The inputs: a padded batch [B 4, T 5] of H 3 whose rows have lengths 1,
T and two between (and no Length input, where a case says so), in
float32 and in bfloat16; both directions, peepholes, origin_mode, given
H0 / C0, activations by name and (gru_unit) by int code, a 2-layer
bidirectional cudnn_lstm with initial states.

Tolerance: every output within 1e-5 (float32) or 2^-7 (bfloat16) of the
largest JAX magnitude; the JAX package's cudnn_lstm returns its final
states as last_h / last_c, the port in the slots the lstm layer declares,
LastH / LastC. Gradients: ``jax.vjp`` of the JAX lowering (one jitted
function for each dtype), every output given a seeded cotangent, against
autograd through the port's lowering, within the same tolerances, for
every float input.

bfloat16: the port runs a bf16 recurrence in float32 and rounds each
output (and each input's gradient) once, so it is held against the JAX
lowering run in float32 on the same bf16-rounded inputs and cotangents.
The JAX lowering run in bf16 rounds every operation of every step
(jax.nn.sigmoid's exp, sum and division each): it drifts from that
reference by more than 2^-7 over five steps, so it is not the reference
there (``test_bf16_jax_rounds_every_op_of_a_step``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg

import torch_resnet_step as step

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -7
B, T, H, P, I = 4, 5, 3, 2, 3
LENS = np.array([1, T, 3, 2], np.int64)
# the JAX cudnn_lstm's slots for the final states -> the port's
SLOT = {"last_h": "LastH", "last_c": "LastC"}


def _randn(*shape, seed=0, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _packed(layers, ndir, seed):
    """cudnn_lstm's packed W: per layer and direction wx, wh, bx, bh."""
    n, isz = 0, I
    for _ in range(layers):
        n += ndir * (4 * H * isz + 4 * H * H + 8 * H)
        isz = H * ndir
    return _randn(n, seed=seed, scale=0.3)


def _lstm_in(seed, bias=4 * H, **extra):
    d = {"Input": [_randn(B, T, 4 * H, seed=seed)],
         "Weight": [_randn(H, 4 * H, seed=seed + 1)],
         "Bias": [_randn(1, bias, seed=seed + 2)], "Length": [LENS]}
    d.update(extra)
    return d


def _gru_in(seed, **extra):
    d = {"Input": [_randn(B, T, 3 * H, seed=seed)],
         "Weight": [_randn(H, 3 * H, seed=seed + 1)],
         "Bias": [_randn(1, 3 * H, seed=seed + 2)], "Length": [LENS]}
    d.update(extra)
    return d


def _lstmp_in(seed, bias=4 * H, **extra):
    d = {"Input": [_randn(B, T, 4 * H, seed=seed)],
         "Weight": [_randn(P, 4 * H, seed=seed + 1)],
         "ProjWeight": [_randn(H, P, seed=seed + 2)],
         "Bias": [_randn(1, bias, seed=seed + 3)], "Length": [LENS]}
    d.update(extra)
    return d


def _gru_unit_in(seed, bias=True):
    d = {"Input": [_randn(B, 3 * H, seed=seed)],
         "HiddenPrev": [_randn(B, H, seed=seed + 1)],
         "Weight": [_randn(H, 3 * H, seed=seed + 2)]}
    if bias:
        d["Bias"] = [_randn(1, 3 * H, seed=seed + 3)]
    return d


def _no_length(d):
    return {k: v for k, v in d.items() if k != "Length"}


# case -> (inputs, attrs). The op is the case's name up to "__".
CASES = {
    "dynamic_lstm": (_lstm_in(1), {}),
    "dynamic_lstm__reverse": (_lstm_in(4), {"is_reverse": True}),
    "dynamic_lstm__peepholes": (_lstm_in(7, bias=7 * H),
                                {"use_peepholes": True}),
    "dynamic_lstm__h0_c0_reverse": (
        _lstm_in(10, H0=[_randn(B, H, seed=13)], C0=[_randn(B, H, seed=14)]),
        {"is_reverse": True}),
    "dynamic_lstm__no_length": (_no_length(_lstm_in(15)), {}),
    "dynamic_lstm__activations": (
        _lstm_in(18), {"gate_activation": "sigmoid",
                       "cell_activation": "identity",
                       "candidate_activation": "relu"}),
    "lstm__peepholes_reverse": (_lstm_in(21, bias=7 * H),
                                {"use_peepholes": True, "is_reverse": True}),
    "dynamic_gru": (_gru_in(24), {}),
    "dynamic_gru__reverse": (_gru_in(27), {"is_reverse": True}),
    "dynamic_gru__origin_mode": (_gru_in(30), {"origin_mode": True}),
    "dynamic_gru__h0_reverse": (_gru_in(33, H0=[_randn(B, H, seed=36)]),
                                {"is_reverse": True}),
    "dynamic_gru__no_length_activations": (
        _no_length(_gru_in(37)), {"gate_activation": "sigmoid",
                                  "activation": "relu"}),
    "gru__origin_mode_reverse": (_gru_in(40), {"origin_mode": True,
                                               "is_reverse": True}),
    "lstmp": (_lstmp_in(43), {}),
    "lstmp__peepholes_reverse": (_lstmp_in(47, bias=7 * H),
                                 {"use_peepholes": True,
                                  "is_reverse": True}),
    "lstmp__h0_c0_clips": (
        _lstmp_in(51, H0=[_randn(B, P, seed=55)],
                  C0=[_randn(B, H, seed=56)]),
        {"proj_activation": "identity", "cell_clip": 1e-3,
         "proj_clip": 1e-3}),
    "cudnn_lstm": ({"Input": [_randn(T, B, I, seed=57)],
                    "W": [_packed(1, 1, 58)]},
                   {"hidden_size": H, "num_layers": 1}),
    "cudnn_lstm__2_layers_bidirec": (
        {"Input": [_randn(T, B, I, seed=59)], "W": [_packed(2, 2, 60)],
         "InitH": [_randn(4, B, H, seed=61)],
         "InitC": [_randn(4, B, H, seed=62)]},
        {"hidden_size": H, "num_layers": 2, "is_bidirec": True,
         "dropout_prob": 0.5, "is_test": False}),
    "cudnn_lstm__2_layers": (
        {"Input": [_randn(T, B, I, seed=63)], "W": [_packed(2, 1, 64)],
         "InitH": [_randn(2, B, H, seed=65)],
         "InitC": [_randn(2, B, H, seed=66)]},
        {"hidden_size": H, "num_layers": 2}),
    "gru_unit": (_gru_unit_in(67), {"activation": "tanh",
                                    "gate_activation": "sigmoid"}),
    "gru_unit__int_codes": (_gru_unit_in(71), {"activation": 2,
                                               "gate_activation": 1}),
    "gru_unit__other_int_codes": (_gru_unit_in(75), {"activation": 3,
                                                     "gate_activation": 2}),
    "gru_unit__identity_no_bias": (_gru_unit_in(79, bias=False),
                                   {"activation": "identity",
                                    "gate_activation": "sigmoid"}),
    "gru_unit__origin_mode": (_gru_unit_in(82), {"origin_mode": True}),
    "lstm_unit": ({"X": [_randn(B, 4 * H, seed=86)],
                   "C_prev": [_randn(B, H, seed=87)]}, {}),
    "lstm_unit__forget_bias": ({"X": [_randn(B, 4 * H, seed=88)],
                                "C_prev": [_randn(B, H, seed=89)]},
                               {"forget_bias": 1.0}),
}
RNN_OPS = {"dynamic_lstm", "lstm", "dynamic_gru", "gru", "lstmp",
           "cudnn_lstm", "gru_unit", "lstm_unit"}


def _op(case):
    return case.split("__")[0]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x).astype(np.float64)


def _inputs(arrays, bf16=False, jax_bf16=False):
    """(JAX inputs, port inputs). bf16: the port's float inputs in
    bfloat16, the JAX ones the same values in float32 (in bfloat16 too
    with jax_bf16)."""
    def j(a):
        a = jnp.asarray(a)
        if bf16 and a.dtype == jnp.float32:
            a = a.astype(jnp.bfloat16)
            return a if jax_bf16 else a.astype(jnp.float32)
        return a

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if bf16 and a.dtype == torch.float32 \
            else a
    return ({k: [j(a) for a in v] for k, v in arrays.items()},
            {k: [t(a) for a in v] for k, v in arrays.items()})


def _check(got, want, tol, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    assert np.isfinite(got).all() and np.isfinite(want).all(), err_msg
    bound = tol * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (
        err_msg, np.abs(got - want).max(), bound)


def _compare(case, want, bf16):
    """The port's outputs of `case` against the JAX lowering's `want`
    ({slot: array})."""
    arrays, attrs = CASES[case]
    _, tin = _inputs(arrays, bf16)
    got = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                       attrs)
    assert set(got) == {SLOT.get(s, s) for s in want}, (sorted(got),
                                                        sorted(want))
    tol = BF16_TOL if bf16 else F32_TOL
    for slot, w in want.items():
        gs = got[SLOT.get(slot, slot)]
        assert len(gs) == 1, slot
        assert gs[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
        _check(gs[0], w, tol, err_msg=slot)


def test_the_cases_cover_the_slice():
    """The 8 lowerings, each with a case, in both packages, all with a
    gradient; with recurrent, every lowering of the JAX rnn_ops.py; the
    port holds 311 with fusion_ops.py's 14, 297 before them (with
    test_torch_decode_ops.py's 6 and
    test_torch_ctc_pool_ops.py's 9), none the JAX package lacks."""
    assert {_op(c) for c in CASES} == RNN_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("rnn_ops")} == RNN_OPS | {"recurrent"}
    assert all(treg._LOWERINGS[op].__module__.endswith("rnn_ops")
               for op in RNN_OPS)
    assert not any(jreg.is_no_grad(op) or treg.is_no_grad(op)
                   for op in RNN_OPS)
    assert len(treg._LOWERINGS) == 311
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


def _float_keys(arrays):
    return [(k, i) for k, v in arrays.items() for i, a in enumerate(v)
            if a.dtype == np.float32]


@functools.lru_cache(maxsize=None)
def _jax_lowerings():
    """(each case's JAX lowering as a function of its float32 inputs, its
    output shapes by slot, one jitted function of every case's inputs and
    cotangents that gives its outputs and jax.vjp's gradients). The
    bfloat16 references call the same compiled function on rounded
    values."""
    fns, shapes = [], []
    for case in sorted(CASES):
        arrays, attrs = CASES[case]
        jin, _ = _inputs(arrays)
        keys = _float_keys(arrays)

        def fn(*xs, jin=jin, keys=keys, attrs=attrs, case=case):
            ins = {k: list(v) for k, v in jin.items()}
            for (k, i), x in zip(keys, xs):
                ins[k][i] = x
            outs = jreg.get_lowering(_op(case))(jreg.LoweringContext(), ins,
                                                attrs)
            return {s: v[0] for s, v in outs.items()}
        fns.append(fn)
        shapes.append({s: o.shape for s, o in jax.eval_shape(
            fn, *[jin[k][i] for k, i in keys]).items()})

    @jax.jit
    def all_vjps(args, cots):
        res = []
        for fn, xs, cs in zip(fns, args, cots):
            outs, vjp = jax.vjp(fn, *xs)
            res.append((outs, vjp(cs)))
        return res
    return fns, shapes, all_vjps


def _jax_vjps(bf16):
    """{case: (cotangents by JAX slot, the JAX outputs by slot, the JAX
    gradients)}; bf16: of the float32 lowering on the bfloat16-rounded
    inputs and cotangents."""
    _, shapes, all_vjps = _jax_lowerings()
    args, cots = [], []
    for case, shape in zip(sorted(CASES), shapes):
        arrays, _ = CASES[case]
        jin, _ = _inputs(arrays, bf16)
        args.append([jin[k][i] for k, i in _float_keys(arrays)])
        cs = {s: np.random.RandomState(90 + n).randn(*shape[s])
              .astype(np.float32) for n, s in enumerate(sorted(shape))}
        # bf16: the cotangents rounded as the port's are
        cots.append({s: torch.from_numpy(c).to(torch.bfloat16).float()
                     .numpy() if bf16 else c for s, c in cs.items()})
    res = all_vjps(args, [{s: jnp.asarray(c) for s, c in cs.items()}
                          for cs in cots])
    return {c: (cs, o, g) for c, cs, (o, g) in zip(sorted(CASES), cots,
                                                   res)}


def _port_grads(case, cots, bf16):
    arrays, attrs = CASES[case]
    _, tin = _inputs(arrays, bf16)
    leaves = []
    for k, i in _float_keys(arrays):
        tin[k][i] = tin[k][i].clone().requires_grad_(True)
        leaves.append(tin[k][i])
    outs = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                        attrs)
    slots = sorted(cots)
    ys = [outs[SLOT.get(s, s)][0] for s in slots]
    got = torch.autograd.grad(
        ys, leaves, [torch.from_numpy(cots[s]).to(y.dtype)
                     for s, y in zip(slots, ys)], allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


@pytest.fixture(scope="module")
def jax_vjps():
    return _jax_vjps(bf16=False)


@pytest.fixture(scope="module")
def jax_vjps_bf16():
    return _jax_vjps(bf16=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, jax_vjps):
    _compare(case, jax_vjps[case][1], bf16=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_matches_jax(case, jax_vjps_bf16):
    _compare(case, jax_vjps_bf16[case][1], bf16=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_jax_vjp(case, jax_vjps):
    cots, _, want = jax_vjps[case]
    got = _port_grads(case, cots, bf16=False)
    keys = _float_keys(CASES[case][0])
    assert len(got) == len(want) == len(keys)
    for key, g, w in zip(keys, got, want):
        _check(g, w, F32_TOL, err_msg="%s[%d]" % key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_gradient_matches_jax_vjp(case, jax_vjps_bf16):
    cots, _, want = jax_vjps_bf16[case]
    got = _port_grads(case, cots, bf16=True)
    for key, g, w in zip(_float_keys(CASES[case][0]), got, want):
        assert g.dtype == torch.bfloat16
        _check(g, w, BF16_TOL, err_msg="%s[%d]" % key)


def test_bf16_jax_rounds_every_op_of_a_step():
    """The JAX lowerings run in bf16 round every operation of a step:
    over the five steps of a 2-layer bidirectional cudnn_lstm and a
    dynamic_lstm their outputs drift more than 2^-7 of
    the largest from the same lowering run in float32 on the same inputs
    (lstm_unit in its one step); the port's bf16 run lies within it
    (ROADMAP Queue 3)."""
    for case in ("cudnn_lstm__2_layers_bidirec", "dynamic_lstm",
                 "lstm_unit"):
        arrays, attrs = CASES[case]
        lower = jreg.get_lowering(_op(case))
        j32, t16 = _inputs(arrays, bf16=True)
        j16, _ = _inputs(arrays, bf16=True, jax_bf16=True)
        want = lower(jreg.LoweringContext(), j32, attrs)
        jax16 = lower(jreg.LoweringContext(), j16, attrs)
        port = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"),
                                            t16, attrs)
        drift = max(np.abs(_np(jax16[s][0]) - _np(want[s][0])).max() /
                    np.abs(_np(want[s][0])).max() for s in want)
        assert drift > BF16_TOL, (case, drift)
        for s in want:
            _check(port[SLOT.get(s, s)][0], want[s][0], BF16_TOL, s)


# --------------------------------------------------------------------------
# the traps, pinned on the port alone
# --------------------------------------------------------------------------

def _lower(op, inputs, attrs):
    return treg.get_lowering(op)(treg.LoweringContext("cpu"),
                                 {k: [torch.from_numpy(v) for v in vs]
                                  for k, vs in inputs.items()}, attrs)


@pytest.mark.parametrize("op", ["dynamic_lstm", "dynamic_gru", "lstmp"])
def test_pad_positions_carry_the_state(op):
    """Past a row's length a forward recurrence outputs its last real
    state at every pad position; a reverse one outputs its initial state
    (zeros) until it reaches the row's last real token."""
    ins = {"dynamic_lstm": _lstm_in, "dynamic_gru": _gru_in,
           "lstmp": _lstmp_in}[op](100)
    slot = "Projection" if op == "lstmp" else "Hidden"
    fwd = _lower(op, ins, {})[slot][0]
    rev = _lower(op, ins, {"is_reverse": True})[slot][0]
    for row, n in enumerate(LENS):
        for t in range(n, T):
            assert torch.equal(fwd[row, t], fwd[row, n - 1])
            assert not rev[row, t].any()
        assert rev[row, n - 1].abs().min() > 0
        assert fwd[row, :n].abs().min() > 0


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def test_lstmp_matches_numpy_loop():
    """tests/test_sequence_rnn.py's oracle on the port: lstmp against a
    step-by-step numpy recurrence over the projection."""
    rng = np.random.RandomState(7)
    b, t, h, p = 3, 6, 5, 4
    x = rng.randn(b, t, 4 * h).astype("float32")
    w = rng.randn(p, 4 * h).astype("float32") * 0.1
    wp = rng.randn(h, p).astype("float32") * 0.1
    bias = rng.randn(1, 4 * h).astype("float32") * 0.1
    length = np.array([6, 4, 2], dtype="int64")
    proj = _lower("lstmp", {"Input": [x], "Weight": [w], "ProjWeight": [wp],
                            "Bias": [bias], "Length": [length]},
                  {})["Projection"][0].numpy()
    r = np.zeros((b, p), "float32")
    c = np.zeros((b, h), "float32")
    want = np.zeros((b, t, p), "float32")
    for s in range(t):
        gates = x[:, s] + bias + r @ w
        i, f, ch, o = np.split(gates, 4, axis=-1)
        c_new = _sig(f) * c + _sig(i) * np.tanh(ch)
        r_new = np.tanh((_sig(o) * np.tanh(c_new)) @ wp)
        alive = (s < length)[:, None]
        r = np.where(alive, r_new, r)
        c = np.where(alive, c_new, c)
        want[:, s] = r
    np.testing.assert_allclose(proj, want, rtol=1e-4, atol=1e-4)


def test_cudnn_lstm_single_layer_matches_numpy():
    """tests/test_sequence_rnn.py's oracle on the port: one cudnn_lstm
    layer against a numpy loop over the unpacked wx, wh, bx, bh; its
    LastH / LastC are the loop's final h and c."""
    rng = np.random.RandomState(11)
    t, b, i, h = 4, 2, 3, 5
    x = rng.randn(t, b, i).astype("float32")
    wx = rng.randn(4 * h, i).astype("float32") * 0.2
    wh = rng.randn(4 * h, h).astype("float32") * 0.2
    bx = rng.randn(4 * h).astype("float32") * 0.1
    bh = rng.randn(4 * h).astype("float32") * 0.1
    flat = np.concatenate([wx.ravel(), wh.ravel(), bx, bh])
    out = _lower("cudnn_lstm", {"Input": [x], "W": [flat]},
                 {"hidden_size": h, "num_layers": 1, "is_bidirec": False})
    hs = np.zeros((b, h), "float32")
    cs = np.zeros((b, h), "float32")
    want = np.zeros((t, b, h), "float32")
    for s in range(t):
        gates = x[s] @ wx.T + hs @ wh.T + bx + bh
        gi, gf, gg, go = np.split(gates, 4, axis=-1)
        cs = _sig(gf) * cs + _sig(gi) * np.tanh(gg)
        hs = _sig(go) * np.tanh(cs)
        want[s] = hs
    np.testing.assert_allclose(out["Out"][0].numpy(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["LastH"][0].numpy(), hs[None],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["LastC"][0].numpy(), cs[None],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op,inputs,attrs", [
    ("dynamic_lstm", _lstm_in(110), {"use_peepholes": True}),
    ("lstmp", _lstmp_in(113), {"use_peepholes": True}),
    ("cudnn_lstm", {"Input": [_randn(T, B, I, seed=117)],
                    "W": [_packed(1, 1, 118)[:-1]]},
     {"hidden_size": H, "num_layers": 1})])
def test_bad_weights_raise_as_in_the_jax_package(op, inputs, attrs):
    """Peepholes over a [1, 4H] bias, a packed W one element short: the
    same ValueError in both packages."""
    jin, tin = _inputs(inputs)
    msgs = []
    for reg, ctx, ins in ((jreg, jreg.LoweringContext(), jin),
                          (treg, treg.LoweringContext("cpu"), tin)):
        with pytest.raises(ValueError) as e:
            reg.get_lowering(op)(ctx, ins, attrs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

def _seq_data(L, name, width):
    return L.data(name=name, shape=[-1, width], dtype="float32",
                  lod_level=1)


def _layer_dynamic_lstm(fluid):
    L = fluid.layers
    x = _seq_data(L, "x", 4 * H)
    h0 = L.data(name="h0", shape=[H], dtype="float32")
    hidden, cell = L.dynamic_lstm(x, 4 * H, h_0=h0, c_0=h0,
                                  use_peepholes=True, is_reverse=True)
    return [hidden, cell]


def _layer_dynamic_lstmp(fluid):
    L = fluid.layers
    proj, cell = L.dynamic_lstmp(_seq_data(L, "x", 4 * H), 4 * H, P,
                                 cell_clip=1.0, proj_clip=1.0)
    return [proj, cell]


def _layer_dynamic_gru(fluid):
    L = fluid.layers
    return [L.dynamic_gru(_seq_data(L, "x", 3 * H), H, origin_mode=True)]


def _layer_gru_unit(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3 * H], dtype="float32")
    h = L.data(name="h", shape=[H], dtype="float32")
    return list(L.gru_unit(x, h, 3 * H, origin_mode=True))


def _layer_lstm_unit(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[I], dtype="float32")
    h = L.data(name="h", shape=[H], dtype="float32")
    c = L.data(name="c", shape=[H], dtype="float32")
    return list(L.lstm_unit(x, h, c, forget_bias=1.0))


def _layer_lstm(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[-1, -1, I], dtype="float32",
               append_batch_size=False)
    init = L.data(name="init", shape=[4, -1, H], dtype="float32",
                  append_batch_size=False)
    return list(L.lstm(x, init, init, max_len=T, hidden_size=H,
                       num_layers=2, is_bidirec=True))


LAYERS = {"dynamic_lstm": _layer_dynamic_lstm,
          "dynamic_lstmp": _layer_dynamic_lstmp,
          "dynamic_gru": _layer_dynamic_gru, "gru_unit": _layer_gru_unit,
          "lstm_unit": _layer_lstm_unit, "lstm": _layer_lstm}


def _build(fluid, layer):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        outs = LAYERS[layer](fluid)
    return main, startup, outs


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_builds_the_jax_packages_program(layer):
    """Each layer: op for op the JAX package's program, parameters,
    startup and output shapes (a free time axis -1 through shape
    inference's loop), but the lstm layer's final states, whose shapes the
    JAX package leaves unset (its lowering writes last_h / last_c); the
    lengths of a ragged input carried to the outputs."""
    jm, js, jouts = _build(jfluid, layer)
    tm, ts, touts = _build(tfluid, layer)
    jops, jvars = step.signature(jm)
    tops, tvars = step.signature(tm)
    assert jops == tops
    assert step.signature(js) == step.signature(ts)
    final = {o.name for o in touts[1:]} if layer == "lstm" else set()
    assert [v for v in jvars if v[0] not in final] == \
        [v for v in tvars if v[0] not in final]
    for j, t in zip(jouts, touts):
        if t.name in final:
            assert j.shape is None and tuple(t.shape) == (4, -1, H)
        else:
            assert tuple(j.shape) == tuple(t.shape)
        assert getattr(j, "seq_length_var", None) == \
            getattr(t, "seq_length_var", None)
    if layer.startswith("dynamic"):
        assert touts[0].shape == (-1, -1, P if layer == "dynamic_lstmp"
                                  else H)
        assert touts[0].seq_length_var == "x@LEN"


def _run_layer(fluid, layer, feed, fetch_index, state=None):
    """`layer`'s program run on `feed` from its startup (the parameters
    `state` instead, where given): the outputs `fetch_index`, and the
    parameters."""
    main, startup, outs = _build(fluid, layer)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, value in (state or {}).items():
        scope.set(name, value if fluid is jfluid else torch.from_numpy(value))
    params = {p.name: np.asarray(scope.get(p.name))
              for p in main.all_parameters()}
    return exe.run(main, feed=feed, fetch_list=[outs[i] for i in
                                                fetch_index],
                   scope=scope), params


def test_lstm_final_states_fetch_on_the_port_only():
    """layers.lstm's LastH / LastC: the JAX lowering writes last_h /
    last_c, so fetching the layer's final state raises KeyError in the JAX
    executor; the port holds them. For the one forward layer of a
    unidirectional lstm, LastH is Out at the last step."""
    rng = np.random.RandomState(120)

    def one_layer(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[-1, -1, I], dtype="float32",
                   append_batch_size=False)
        init = L.data(name="init", shape=[1, -1, H], dtype="float32",
                      append_batch_size=False)
        return list(L.lstm(x, init, init, max_len=T, hidden_size=H,
                           num_layers=1))
    LAYERS["lstm_one_layer"] = one_layer
    try:
        feed = {"x": rng.randn(T, B, I).astype("float32"),
                "init": rng.randn(1, B, H).astype("float32")}
        with pytest.raises(KeyError):
            _run_layer(jfluid, "lstm_one_layer", feed, [1])
        (jout,), state = _run_layer(jfluid, "lstm_one_layer", feed, [0])
        (out, last_h, last_c), _ = _run_layer(
            tfluid, "lstm_one_layer", feed, [0, 1, 2], state)
    finally:
        del LAYERS["lstm_one_layer"]
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6)
    assert last_h.shape == last_c.shape == (1, B, H)
    np.testing.assert_array_equal(last_h[0], out[-1])
    assert np.isfinite(last_c).all() and np.abs(last_c).min() > 0


def test_clips_and_origin_mode_are_ignored_in_both_packages():
    """dynamic_lstmp's cell_clip and proj_clip reach the op and change
    nothing; gru_unit's origin_mode never reaches it: in both packages the
    outputs equal those built without them (the Paddle reference clips
    and interpolates the other way)."""
    rng = np.random.RandomState(121)
    x = rng.randn(B, T, 4 * H).astype("float32") * 3.0
    feeds = {"dynamic_lstmp": {"x": x, "x@LEN": LENS},
             "gru_unit": {"x": rng.randn(B, 3 * H).astype("float32"),
                          "h": rng.randn(B, H).astype("float32")}}

    def plain_lstmp(fluid):
        L = fluid.layers
        return list(L.dynamic_lstmp(_seq_data(L, "x", 4 * H), 4 * H, P))

    def plain_gru_unit(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3 * H], dtype="float32")
        h = L.data(name="h", shape=[H], dtype="float32")
        return list(L.gru_unit(x, h, 3 * H))
    LAYERS.update(plain_lstmp=plain_lstmp, plain_gru_unit=plain_gru_unit)
    try:
        for fluid in (jfluid, tfluid):
            for layer, plain, n in (("dynamic_lstmp", "plain_lstmp", 2),
                                    ("gru_unit", "plain_gru_unit", 3)):
                got, state = _run_layer(fluid, layer, feeds[layer],
                                        range(n))
                want, _ = _run_layer(fluid, plain, feeds[layer], range(n),
                                     state)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                if layer == "dynamic_lstmp":
                    # unclipped: the cell leaves [-1, 1]
                    assert np.abs(got[1]).max() > 1.0
    finally:
        del LAYERS["plain_lstmp"], LAYERS["plain_gru_unit"]


def test_dynamic_lstm_freezes_past_length():
    """tests/test_sequence_rnn.py's oracle on the port: over ragged xs,
    fc then dynamic_lstm; row 1 (length 2) keeps its step-1 hidden state
    to the end."""
    rng = np.random.RandomState(1)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        xs = tfluid.layers.data(name="xs", shape=[6, 8], dtype="float32",
                                lod_level=1)
        proj = tfluid.layers.fc(input=xs, size=16, num_flatten_dims=2,
                                bias_attr=False)
        proj.seq_length_var = xs.seq_length_var
        hidden, cell = tfluid.layers.dynamic_lstm(proj, size=16)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    h, = exe.run(main, feed={"xs": rng.rand(3, 6, 8).astype("float32"),
                             "xs@LEN": np.array([6, 2, 4], "int64")},
                 fetch_list=[hidden], scope=scope)
    np.testing.assert_array_equal(h[1, 1], h[1, 5])
    assert not np.array_equal(h[0, 1], h[0, 5])


def test_dynamic_lstmp_layer_trains():
    """tests/test_sequence_rnn.py's oracle on the port: fc, dynamic_lstmp,
    the mean, SGD(0.1): the loss moves in 4 steps."""
    rng = np.random.RandomState(3)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        layers = tfluid.layers
        x = layers.data(name="x", shape=[6, 16], dtype="float32")
        proj = layers.fc(input=x, size=4 * 8, num_flatten_dims=2)
        hidden, _cell = layers.dynamic_lstmp(proj, size=4 * 8, proj_size=5)
        loss = layers.mean(hidden)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": rng.randn(2, 6, 16).astype("float32")}
    ls = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
          for _ in range(4)]
    assert ls[-1] != ls[0]
    assert all(np.isfinite(ls))
