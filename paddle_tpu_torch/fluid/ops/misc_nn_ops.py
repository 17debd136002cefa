"""Long-tail NN lowerings (the port's counterpart of
``paddle_tpu/fluid/ops/misc_nn_ops.py``): the 3-D and depthwise transposed
convolutions, spectral_norm, affine_grid, fsp, similarity_focus,
hierarchical_sigmoid, sample_logits, tree_conv and
sampled_softmax_with_cross_entropy, each with the JAX lowering's
semantics.

Row sums in order: on the card, tree_conv's child sums and the gradients
of hierarchical_sigmoid's row picks go through ``scatter_rows_`` (rows of
a table, added in batch order), and the gradients of sample_logits' and
sampled softmax's picks along each row through ``add_along_rows_``, so
the card gives the same bits in every run. Sampling draws from the run's
``torch.Generator`` (``ctx.next_rng``), so the samples differ from the
JAX package's; the random ops are held by invariants.
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import compute_dtype, one
from .nn_ops import convolution
from .registry import register_lowering
from .tensor_ops import _Gather, _ScatterAdd, scatter_rows_


@register_lowering("conv3d_transpose")
def _conv3d_transpose(ctx, inputs, attrs):
    """The JAX package's ``conv_transpose_nd`` (an input-dilated
    convolution by the flipped filter, Fluid's [in_c, out_c / groups, k,
    k, k] filter) is ``F.conv_transpose3d`` by the filter as it stands."""
    x, w = one(inputs, "Input"), one(inputs, "Filter")
    out = convolution(x, w, attrs.get("strides", [1, 1, 1]),
                      attrs.get("paddings", [0, 0, 0]),
                      attrs.get("dilations", [1, 1, 1]),
                      attrs.get("groups", 1) or 1, transposed=True)
    return {"Output": [out]}


@register_lowering("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, inputs, attrs):
    """groups as the JAX lowering reads it, ``attrs.get("groups", 1) or
    C``: a groups of 0 or None takes the input's channels, a groups of 1
    (or none set) stays 1."""
    x, w = one(inputs, "Input"), one(inputs, "Filter")
    out = convolution(x, w, attrs.get("strides", [1, 1]),
                      attrs.get("paddings", [0, 0]),
                      attrs.get("dilations", [1, 1]),
                      attrs.get("groups", 1) or x.shape[1], transposed=True)
    return {"Output": [out]}


def _power_iterations(wm, u, v, steps, eps):
    """`steps` steps of power iteration over the matrix wm from (u, v),
    without gradient."""
    with torch.no_grad():
        for _ in range(max(steps, 0)):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    return u.detach(), v.detach()


class _SpectralNormOut(torch.autograd.Function):
    """W / (sigma + eps) with sigma = u W v from the forward's iteration;
    its gradient is that of W / (u' W v' + eps), u' and v' constants, from
    power_iters more steps from u and v: the gradient the JAX executor
    (and the Paddle reference's spectral_norm_grad) computes, its grad op
    re-running the forward from U and V after the forward wrote UOut and
    VOut into them (ROADMAP Queue 3)."""

    @staticmethod
    def forward(fctx, w, u, v, perm, steps, eps):
        wm = w.permute(perm).reshape(w.shape[perm[0]], -1)
        fctx.save_for_backward(w, u, v)
        fctx.conf = (perm, steps, eps)
        return w / ((u @ wm) @ v + eps)

    @staticmethod
    def backward(fctx, g):
        w, u, v = fctx.saved_tensors
        perm, steps, eps = fctx.conf
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            wm = w.permute(perm).reshape(w.shape[perm[0]], -1)
            u, v = _power_iterations(wm, u, v, steps, eps)
            dw, = torch.autograd.grad(w / ((u @ wm) @ v + eps), w, g)
        return dw, None, None, None, None, None


@register_lowering("spectral_norm")
def _spectral_norm(ctx, inputs, attrs):
    """Weight / sigma_max by power_iters steps of power iteration from U
    and V over the weight as a [shape[dim], -1] matrix, sigma = u W v;
    the gradient stops at u and v (``_SpectralNormOut``). UOut and VOut
    carry u and v to the next step. Half precision is computed in float32
    and rounded once."""
    w, u, v = one(inputs, "Weight"), one(inputs, "U"), one(inputs, "V")
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    steps = attrs.get("power_iters", 1)
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    dtype = compute_dtype(w)
    wf = w.to(dtype)
    wm = wf.detach().permute(perm).reshape(w.shape[dim], -1)
    u, v = _power_iterations(wm, u.reshape(-1).to(dtype),
                             v.reshape(-1).to(dtype), steps, eps)
    out = _SpectralNormOut.apply(wf, u, v, perm, steps, eps)
    return {"Out": [out.to(w.dtype)], "UOut": [u.to(w.dtype)],
            "VOut": [v.to(w.dtype)]}


@register_lowering("affine_grid")
def _affine_grid(ctx, inputs, attrs):
    """Theta [N, 2, 3] -> the float32 sampling grid [N, H, W, 2] of
    ``output_shape`` over linspace(-1, 1) corners, each point x * theta[:,
    :, 0] + y * theta[:, :, 1] + theta[:, :, 2]; an OutputShape tensor
    raises."""
    if one(inputs, "OutputShape") is not None:
        raise NotImplementedError(
            "affine_grid: a runtime OutputShape tensor is dynamic; pass the "
            "static output_shape attr")
    theta = one(inputs, "Theta").float()
    _, _, h, w = [int(d) for d in attrs.get("output_shape")]
    gy, gx = torch.meshgrid(_linspace(h, theta.device),
                            _linspace(w, theta.device), indexing="ij")
    # [N, H, W, 2]: sum_k base[h, w, k] theta[n, c, k], k in order
    t = theta[:, None, None, :, :]
    out = gx[..., None] * t[..., 0] + gy[..., None] * t[..., 1] + t[..., 2]
    return {"Output": [out]}


def _linspace(num, device):
    """``jnp.linspace(-1, 1, num)``'s formula, -1 * (1 - s) + 1 * s with s
    = i / (num - 1) and the last point 1, in float32 elementwise ops: the
    same bits on the card and on the CPU (``torch.linspace``'s two kernels
    round apart; XLA's fused form may round an ulp apart from both)."""
    if num == 1:
        return torch.full((1,), -1.0, device=device)
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        float(num - 1)
    return torch.cat([-1.0 * (1 - s) + 1.0 * s,
                      torch.ones(1, device=device)])


@register_lowering("fsp")
def _fsp(ctx, inputs, attrs):
    """The [N, C1, C2] Gram matrix of two maps over their H * W positions,
    divided by H * W, in X's dtype."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    n, hw = x.shape[0], x.shape[2] * x.shape[3]
    out = torch.einsum("nch,ndh->ncd", x.reshape(n, x.shape[1], hw),
                       y.reshape(n, y.shape[1], hw)) / hw
    return {"Out": [out.to(x.dtype)]}


@register_lowering("similarity_focus", no_grad=True)
def _similarity_focus(ctx, inputs, attrs):
    """For each channel of ``indexes`` and each instance, min(H, W) greedy
    steps: the first maximum (row-major) among the rows and columns not
    yet taken lights up mask[h, w] and takes its row and column; the
    channels' masks combine by max and are broadcast over every channel."""
    x = one(inputs, "X")
    axis = attrs.get("axis", 1)
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    n, c, h, w = x.shape
    rows = torch.arange(n, device=x.device)
    acc = x.new_zeros((n, h, w), dtype=torch.float32)
    for idx in attrs.get("indexes", [0]):
        plane = x[:, idx]
        mask = torch.zeros_like(acc)
        free_r = torch.ones((n, h), dtype=torch.bool, device=x.device)
        free_c = torch.ones((n, w), dtype=torch.bool, device=x.device)
        for _ in range(min(h, w)):
            avail = free_r[:, :, None] & free_c[:, None, :]
            flat = plane.masked_fill(~avail, -math.inf).reshape(n, -1) \
                .argmax(dim=1)
            r, col = flat // w, flat % w
            mask[rows, r, col] = 1.0
            free_r[rows, r] = False
            free_c[rows, col] = False
        acc = torch.maximum(acc, mask)
    out = acc[:, None].expand(n, c, h, w)
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return {"Out": [out.to(x.dtype)]}


@functools.lru_cache(maxsize=None)
def _binary_tree_paths(num_classes):
    """The complete binary tree's code tables (the Paddle reference's
    math/matrix_bit_code.h SimpleCode): class l's leaf is node l + K - 1,
    the internal nodes 0 .. K - 2. Returns (depth, path_table [K, D] of
    internal-node ids (-1 pad), code_table [K, D] of right-child flags),
    numpy, read-only (cached: never written)."""
    k = int(num_classes)
    depth = max(int(np.ceil(np.log2(max(k, 2)))), 1)
    path = np.full((k, depth), -1, np.int64)
    code = np.zeros((k, depth), np.int64)
    for label in range(k):
        node = label + k - 1
        chain = []
        while node > 0:
            parent = (node - 1) // 2
            chain.append((parent, node == 2 * parent + 2))
            node = parent
        chain.reverse()
        for d, (p, is_right) in enumerate(chain[:depth]):
            path[label, d] = p
            code[label, d] = int(is_right)
    path.setflags(write=False)
    code.setflags(write=False)
    return depth, path, code


@register_lowering("hierarchical_sigmoid")
def _hierarchical_sigmoid(ctx, inputs, attrs):
    """Hierarchical sigmoid over the default complete binary tree (or a
    PathTable / PathCode): each label's path of internal nodes picks rows
    of W and Bias (``_Gather``: their gradients add rows in order through
    scatter_rows_); Out [B, 1] = the sum over the path's real nodes of
    softplus(logit) - code * logit; PreOut = sigmoid(logits) [B, D]."""
    x, w = one(inputs, "X"), one(inputs, "W")
    label, bias = one(inputs, "Label"), one(inputs, "Bias")
    ptab, pcode = one(inputs, "PathTable"), one(inputs, "PathCode")
    if ptab is None:
        _, path_np, code_np = _binary_tree_paths(attrs.get("num_classes", 2))
        ptab = torch.tensor(path_np, device=x.device)
        pcode = torch.tensor(code_np, device=x.device)
    lab = label.reshape(-1).long()
    paths = ptab.long()[lab]                               # [B, D]
    codes = pcode[lab].to(x.dtype)
    valid = paths >= 0
    safe = paths.clamp(min=0).reshape(-1)
    b, d = paths.shape
    wsel = _Gather.apply(w, safe).reshape(b, d, w.shape[1])
    logits = torch.einsum("bf,bdf->bd", x, wsel)
    if bias is not None:
        logits = logits + _Gather.apply(bias.reshape(-1, 1),
                                        safe).reshape(b, d)
    ce = torch.logaddexp(logits, torch.zeros_like(logits)) - codes * logits
    loss = torch.where(valid, ce, torch.zeros_like(ce)).sum(
        dim=1, keepdim=True)
    return {"Out": [loss.to(x.dtype)],
            "PreOut": [torch.sigmoid(logits).to(x.dtype)]}


def add_along_rows_(dst, idx, vals):
    """``dst[b, idx[b, j]] += vals[b, j]`` in place on a 2-D dst (the
    gradient of ``take_along_axis`` along dim 1), which it returns. On the
    card ``index_put_(accumulate=True)`` on the flat tensor: the ids
    sorted stably and each run summed without atomics, the same bits in
    every run (one column: not padded as scatter_rows_ pads, which would
    take 64 times the logits' memory). On the CPU ``index_add_`` on the
    flat tensor, in order of the picks, as the JAX package's scatter."""
    flat = (idx + torch.arange(dst.shape[0], device=dst.device)[:, None] *
            dst.shape[1]).reshape(-1)
    vals = vals.reshape(-1).to(dst.dtype)
    if dst.is_cuda:
        dst.view(-1).index_put_((flat,), vals, accumulate=True)
    else:
        dst.view(-1).index_add_(0, flat, vals)
    return dst


class _TakeAlongRows(torch.autograd.Function):
    """``jnp.take_along_axis(x, idx, axis=1)`` for in-range idx, its
    gradient added through ``add_along_rows_``."""

    @staticmethod
    def forward(fctx, x, idx):
        fctx.save_for_backward(idx)
        fctx.x_shape = x.shape
        return torch.gather(x, 1, idx)

    @staticmethod
    def backward(fctx, g):
        idx, = fctx.saved_tensors
        return add_along_rows_(g.new_zeros(fctx.x_shape), idx, g), None


@register_lowering("sample_logits")
def _sample_logits(ctx, inputs, attrs):
    """num_samples classes a row drawn log-uniformly (floor(exp(u log(K +
    1))) - 1, clamped to [0, K)); Samples = [Labels, drawn], Probabilities
    q = log((s + 2) / (s + 1)) / log(K + 1), SampledLogits = the picked
    logits (a drawn class equal to a label less 1e20 with
    remove_accidental_hits) less log(q + 1e-20), SampledLabels 0 .. NT - 1.
    The customized-samples attr is taken and not read, as in JAX."""
    logits, labels = one(inputs, "Logits"), one(inputs, "Labels")
    b, k = logits.shape
    nt = labels.shape[1]
    s = attrs.get("num_samples", 1)
    gen = ctx.next_rng(attrs.get("seed", 0))
    u = torch.rand((b, s), generator=gen, device=logits.device)
    sampled = torch.floor(torch.exp(u * math.log(k + 1.0)) - 1.0).long() \
        .clamp(0, k - 1)
    labels = labels.long()
    samples = torch.cat([labels, sampled], dim=1)
    q = torch.log((samples + 2.0) / (samples + 1.0)) / math.log(k + 1.0)
    picked = _TakeAlongRows.apply(logits, samples)
    if attrs.get("remove_accidental_hits", True):
        hit = (sampled[:, :, None] == labels[:, None, :]).any(dim=2)
        neg = picked[:, nt:]
        picked = torch.cat([picked[:, :nt],
                            torch.where(hit, neg - 1e20, neg)], dim=1)
    out = picked - torch.log(q + 1e-20)
    return {"Samples": [samples],
            "Probabilities": [q.to(logits.dtype)],
            "SampledLogits": [out.to(logits.dtype)],
            "SampledLabels": [torch.arange(nt, device=logits.device)
                              [None, :].expand(b, nt)]}


@register_lowering("tree_conv")
def _tree_conv(ctx, inputs, attrs):
    """TBCNN's tree convolution in the JAX lowering's dense form: each
    node's patch is itself and the mean of its children (EdgeSet's
    (parent, child) rows; a row with parent == child is padding), out =
    tanh(x Wt + 0.5 mean Wl + 0.5 mean Wr) [B, N, out, M]. The children's
    features add into their parents' rows through scatter_rows_
    (``_ScatterAdd``; the picks' gradient through ``_Gather``)."""
    nodes, edges = one(inputs, "NodesVector"), one(inputs, "EdgeSet")
    filt = one(inputs, "Filter")
    b, n, f = nodes.shape
    par = edges[..., 0].long()
    chi = edges[..., 1].long()
    valid = (par != chi).reshape(-1)
    base = (torch.arange(b, device=nodes.device) * n)[:, None]
    rows, kids = (par + base).reshape(-1), (chi + base).reshape(-1)
    flat = nodes.reshape(b * n, f)
    feats = torch.where(valid[:, None], _Gather.apply(flat, kids),
                        torch.zeros((), dtype=nodes.dtype,
                                    device=nodes.device))
    summ = _ScatterAdd.apply(flat.new_zeros((b * n, f)), rows, feats)
    cnt = scatter_rows_(flat.new_zeros((b * n, 1)), rows,
                        valid[:, None].to(nodes.dtype))
    mean = (summ / torch.clamp(cnt, min=1.0)).reshape(b, n, f)
    dtype = compute_dtype(nodes)
    wt, wl, wr = (filt[:, i].to(dtype) for i in range(3))

    def proj(x, wmat):
        return torch.einsum("bnf,fom->bnom", x.to(dtype), wmat)
    out = proj(nodes, wt) + 0.5 * proj(mean, wl) + 0.5 * proj(mean, wr)
    return {"Out": [torch.tanh(out).to(nodes.dtype)]}


@register_lowering("sampled_softmax_with_cross_entropy")
def _sampled_softmax_ce(ctx, inputs, attrs):
    """Softmax cross-entropy over each row's num_true labels and
    num_samples classes drawn uniformly (the Paddle reference draws
    log-uniformly: ROADMAP Queue 3), or the CustomizedSamples past the
    first num_true columns with their CustomizedProbabilities; each picked
    logit (float32) less log(max(q, 1e-20)), a drawn class equal to a
    label less 1e20 with remove_accidental_hits; Loss [N, 1] the mean of
    -log_softmax over the true columns."""
    logits, label = one(inputs, "Logits"), one(inputs, "Labels")
    n, v = logits.shape
    num_true = attrs.get("num_true", 1)
    label2 = label.reshape(n, num_true).long()
    if attrs.get("use_customized_samples", False):
        samples = one(inputs, "CustomizedSamples").reshape(n, -1).long()
        probs = one(inputs, "CustomizedProbabilities").reshape(n, -1)
        sampled, q = samples[:, num_true:], probs
    else:
        gen = ctx.next_rng(attrs.get("seed", 0))
        sampled = torch.randint(0, v, (n, attrs["num_samples"]),
                                generator=gen, device=logits.device)
        q = torch.full((n, num_true + sampled.shape[1]), 1.0 / v,
                       device=logits.device)
    idx = torch.cat([label2, sampled], dim=1)
    picked = _TakeAlongRows.apply(logits, idx).float()
    adj = picked - torch.log(torch.clamp(q.float(), min=1e-20))
    if attrs.get("remove_accidental_hits", True):
        hit = (sampled[:, None, :] == label2[:, :, None]).any(dim=1)
        adj = torch.cat([adj[:, :num_true], adj[:, num_true:] +
                         torch.where(hit, -1e20, 0.0)], dim=1)
    logp = F.log_softmax(adj, dim=1)
    return {"Loss": [-logp[:, :num_true].mean(dim=1, keepdim=True)]}
