"""append_backward: autodiff by program rewriting.

The port's counterpart of ``paddle_tpu/fluid/backward.py``, op for op: the
same grad ops (the generic ``grad_of`` or an op's own grad maker), the same
``<var>@GRAD`` names, ``@RENAME@`` contributions summed by ``sum`` ops, and
the same Backward role attrs, so a training Program built here equals the
JAX package's. ``calc_gradient`` (``gradients``) appends the grad ops of
targets with respect to chosen inputs, as the JAX package does. How the
grad ops run is the executor's business (ops/grad_ops.py): one forward op
may have the grad ops of several such passes.
"""
from .framework import Variable, grad_var_name, GRAD_VAR_SUFFIX
from .core_types import OpRole, dtype_is_floating
from .ops import registry as op_registry
from .ops.grad_ops import EMPTY_VAR

__all__ = ["append_backward", "calc_gradient", "gradients"]


def _var_dtype(block, name):
    try:
        return block._var_recursive(name).dtype
    except ValueError:
        return None


def _var_stop_gradient(block, name):
    try:
        return block._var_recursive(name).stop_gradient
    except ValueError:
        return False


def _find_op_path(block, targets, sources=None):
    """Ops that (transitively) produce ``targets``; pruned to those reachable
    from ``sources`` when given."""
    needed = set(targets)
    path = []
    for op in reversed(block.ops):
        if op_registry.is_host_op(op.type) and \
                not op_registry.has_grad_maker(op.type):
            continue      # host ops are outside the device grad chain
        if any(o in needed for o in op.output_arg_names):
            path.append(op)
            needed.update(n for n in op.input_arg_names if n != EMPTY_VAR)
    path.reverse()
    if sources:
        reachable = set(sources)
        fwd = []
        for op in path:
            if any(i in reachable for i in op.input_arg_names):
                reachable.update(op.output_arg_names)
                fwd.append(op)
        path = fwd
    return path


class _GradAccumulator(object):
    """Tracks every grad var produced for each forward var; emits a sum op
    when a var's grad has several contributors (@RENAME@ vars + sum)."""

    def __init__(self, block):
        self.block = block
        self.produced = {}  # fwd var name -> [grad var names]
        self.consumed = {}  # fwd var name -> count of grads consumed as OGs

    def register(self, fwd_name):
        """Pick a name for a new grad contribution to fwd_name."""
        canonical = grad_var_name(fwd_name)
        lst = self.produced.setdefault(fwd_name, [])
        n_prior = len(lst) + self.consumed.get(fwd_name, 0)
        name = canonical if n_prior == 0 else \
            "%s@RENAME@%d" % (canonical, n_prior)
        lst.append(name)
        return name

    def consume(self, fwd_name):
        """The grad of fwd_name was consumed as an output-grad by an op that
        overwrites fwd_name; drop the stale contribution."""
        lst = self.produced.pop(fwd_name, None) or []
        self.consumed[fwd_name] = self.consumed.get(fwd_name, 0) + len(lst)

    def resolve(self, fwd_name, ops_out):
        """The single grad var of fwd_name, appending a sum op desc to
        ops_out when there are several contributions."""
        lst = self.produced.get(fwd_name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        canonical = grad_var_name(fwd_name)
        ops_out.append({
            "type": "sum",
            "inputs": {"X": list(lst)},
            "outputs": {"Out": [canonical]},
            "attrs": {OpRole.KEY: OpRole.Backward},
        })
        self.produced[fwd_name] = [canonical]
        return canonical


def _make_grad_descs(op, block, acc, no_grad_set, pending_ops):
    """Grad op descs for one forward op."""
    maker = op_registry.get_grad_maker(op.type)
    if maker is not None:
        # resolve OG names first so makers can reference <out>@GRAD; a
        # grad under a non-canonical name is copied to the canonical one
        og_avail = set()
        for out in op.output_arg_names:
            g = acc.resolve(out, pending_ops)
            if g is not None:
                og_avail.add(out)
                if g != grad_var_name(out):
                    pending_ops.append({
                        "type": "assign",
                        "inputs": {"X": [g]},
                        "outputs": {"Out": [grad_var_name(out)]},
                        "attrs": {OpRole.KEY: OpRole.Backward},
                    })
                    acc.produced[out] = [grad_var_name(out)]
        if op_registry.maker_wants_og(op.type):
            descs, grad_to_var = maker(op, block, no_grad_set, og_avail)
        else:
            descs, grad_to_var = maker(op, block, no_grad_set)
        for out in set(op.output_arg_names) & set(op.input_arg_names):
            if out in og_avail:
                acc.consume(out)
        fixed = []
        for d in descs:
            new_outputs = {}
            for slot, names in d["outputs"].items():
                new_names = []
                for n in names:
                    if n.endswith(GRAD_VAR_SUFFIX) and n != EMPTY_VAR:
                        fwd = grad_to_var.get(n, n[:-len(GRAD_VAR_SUFFIX)])
                        if fwd in no_grad_set or \
                                _var_stop_gradient(block, fwd):
                            new_names.append(EMPTY_VAR)
                            continue
                        new_names.append(acc.register(fwd))
                    else:
                        new_names.append(n)
                new_outputs[slot] = new_names
            d = dict(d, outputs=new_outputs)
            d.setdefault("attrs", {})[OpRole.KEY] = OpRole.Backward
            fixed.append(d)
        return fixed

    # the generic grad op
    inputs = {}
    need_grad = {}
    out_slots = {}
    any_need = False
    for slot, names in op.inputs.items():
        inputs["FWD_IN:" + slot] = list(names)
        flags, ig_names = [], []
        for n in names:
            ok = (n != EMPTY_VAR and n not in no_grad_set and
                  not _var_stop_gradient(block, n) and
                  dtype_is_floating(_var_dtype(block, n) or "float32"))
            flags.append(ok)
            ig_names.append(acc.register(n) if ok else EMPTY_VAR)
            any_need = any_need or ok
        need_grad[slot] = flags
        out_slots["IG:" + slot] = ig_names
    if not any_need:
        return []
    og_present = False
    for slot, names in op.outputs.items():
        ogs = []
        for n in names:
            g = acc.resolve(n, pending_ops)
            ogs.append(g if g is not None else EMPTY_VAR)
            og_present = og_present or g is not None
        inputs["OG:" + slot] = ogs
    if not og_present:
        # nothing flows back through this op; undo the registrations
        for slot, names in op.inputs.items():
            for n, flag in zip(names, need_grad[slot]):
                if flag:
                    lst = acc.produced.get(n)
                    if lst:
                        lst.pop()
                        if not lst:
                            del acc.produced[n]
        return []
    return [{
        "type": "grad_of",
        "inputs": inputs,
        "outputs": out_slots,
        "attrs": {
            "fwd_type": op.type,
            "fwd_attrs": dict(op.attrs),
            "need_grad": need_grad,
            OpRole.KEY: OpRole.Backward,
        },
    }]


def _append_grad_ops(block, op_path, start_grads, no_grad_set):
    """Reverse-walk op_path emitting grad ops; returns the accumulator."""
    acc = _GradAccumulator(block)
    for name, gname in start_grads.items():
        acc.produced[name] = [gname]

    descs = []
    for op in reversed(op_path):
        if op_registry.is_no_grad(op.type) and \
                not op_registry.has_grad_maker(op.type):
            # a gradient into a tensor-array op would vanish: the JAX
            # package refuses it with this message
            if op_registry.is_env_op(op.type) and \
                    any(o in acc.produced for o in op.output_arg_names):
                raise NotImplementedError(
                    "append_backward: op %r is on the gradient path but "
                    "tensor-array ops are not differentiable in the TPU "
                    "build; express the loop with StaticRNN/DynamicRNN "
                    "(lowered to one lax.scan, fully differentiable)"
                    % op.type)
            continue
        if not any(o in acc.produced for o in op.output_arg_names):
            continue
        pending = []
        new_descs = _make_grad_descs(op, block, acc, no_grad_set, pending)
        descs.extend(pending)
        descs.extend(new_descs)

    for d in descs:
        op_obj = block.append_op(type=d["type"], inputs=d["inputs"],
                                 outputs=d["outputs"], attrs=d.get("attrs"))
        # grad vars mirror their forward var's metadata
        for n in op_obj.output_arg_names:
            if n == EMPTY_VAR or block._has_var_recursive(n):
                continue
            base = n.split("@GRAD")[0]
            try:
                fwd = block._var_recursive(base)
                block.create_var(name=n, shape=fwd.shape, dtype=fwd.dtype)
            except ValueError:
                block.create_var(name=n)
    return acc


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    param. Returns [(Parameter, grad Variable)]."""
    assert isinstance(loss, Variable)
    program = loss.block.program
    block = program.global_block()
    no_grad_set = set(no_grad_set or [])
    no_grad_set = {v.name if isinstance(v, Variable) else v
                   for v in no_grad_set}

    loss_grad = grad_var_name(loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or ()), "value": 1.0,
               "dtype": loss.dtype or "float32",
               OpRole.KEY: OpRole.Backward | OpRole.Loss})
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)

    op_path = _find_op_path(block, [loss.name])
    acc = _append_grad_ops(block, op_path, {loss.name: loss_grad},
                           no_grad_set)

    if parameter_list is not None:
        params = [block._var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]

    params_and_grads = []
    finalize = []
    for p in params:
        gname = acc.resolve(p.name, finalize)
        if gname is None:
            continue
        for d in finalize:
            block.append_op(type=d["type"], inputs=d["inputs"],
                            outputs=d["outputs"], attrs=d.get("attrs"))
            if not block._has_var_recursive(d["outputs"]["Out"][0]):
                block.create_var(name=d["outputs"]["Out"][0],
                                 shape=p.shape, dtype=p.dtype)
        finalize = []
        params_and_grads.append((p, block._var_recursive(gname)))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Append the grad ops of ``targets`` (a variable or a list) with
    respect to ``inputs`` (a variable or a list) over the ops that lie
    between them. Each target's gradient starts at ``target_gradients``'
    variable where given, else at a ``fill_constant`` of ones. Returns the
    gradient variable of each input, None where no target reaches it.
    ``grad_of`` has no gradient, so a loss built from the result and
    differentiated again gets no second-order terms."""
    targets = targets if isinstance(targets, list) else [targets]
    inputs = inputs if isinstance(inputs, list) else [inputs]
    if target_gradients and not isinstance(target_gradients, list):
        target_gradients = [target_gradients]
    program = targets[0].block.program
    block = program.global_block()
    no_grad_set = set(no_grad_set or [])
    no_grad_set = {v.name if isinstance(v, Variable) else v
                   for v in no_grad_set}

    start_grads = {}
    for i, t in enumerate(targets):
        tg = target_gradients[i] if target_gradients else None
        gname = grad_var_name(t.name)
        if tg is not None:
            start_grads[t.name] = tg.name
        else:
            block.append_op(
                type="fill_constant",
                outputs={"Out": [gname]},
                attrs={"shape": list(t.shape or ()), "value": 1.0,
                       "dtype": t.dtype or "float32",
                       OpRole.KEY: OpRole.Backward})
            block.create_var(name=gname, shape=t.shape, dtype=t.dtype)
            start_grads[t.name] = gname

    op_path = _find_op_path(block, [t.name for t in targets],
                            [v.name for v in inputs])
    acc = _append_grad_ops(block, op_path, start_grads, no_grad_set)

    grads = []
    finalize = []
    for v in inputs:
        gname = acc.resolve(v.name, finalize)
        for d in finalize:
            block.append_op(type=d["type"], inputs=d["inputs"],
                            outputs=d["outputs"], attrs=d.get("attrs"))
        finalize = []
        grads.append(block._var_recursive(gname) if gname else None)
    return grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``calc_gradient`` under the name of the reference's
    ``fluid.gradients``."""
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
