"""Control-flow layers (the port's counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): the comparison layers,
increment, is_empty, the tensor-array and rank-table layers, While,
Switch, IfElse, StaticRNN, DynamicRNN and Print, with the same ops, slots,
attrs and sub-blocks. A While or a Switch case records its ops on a
sub-block and appends one while or conditional_block op; a StaticRNN
appends one ``recurrent`` op that carries its step ops, with the lengths
of its first step input (``length=``, or the ragged input's
``seq_length_var``) as the op's Length input; IfElse is a row-wise select
over both branches. DynamicRNN takes its lengths from its ragged step
input; Go records a sub-block that one ``go`` host op runs on a thread
(fluid/host_ops.py)."""
from ..layer_helper import LayerHelper
from ..core_types import VarType
from .. import unique_name
from .sequence import get_sequence_length

__all__ = [
    "Print", "IfElse", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "increment", "array_write",
    "array_read", "array_length", "create_array", "While", "Switch", "Go",
    "StaticRNN", "DynamicRNN", "is_empty", "lod_rank_table",
    "max_sequence_len", "lod_tensor_to_array", "array_to_lod_tensor",
    "shrink_memory", "reorder_lod_tensor_by_rank", "split_lod_tensor",
    "merge_lod_tensor"]


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type, input=x)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond
    layer.__name__ = op_type
    return layer


def less_than(x, y, force_cpu=None, cond=None):
    """x < y elementwise (force_cpu is taken for the reference's signature;
    the op runs where its inputs lie)."""
    return _cmp_layer("less_than")(x, y, cond=cond)


less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


def increment(x, value=1.0, in_place=True):
    from .ops import increment as _inc
    return _inc(x, value, in_place)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty", input=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


def create_array(dtype):
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=helper.name, dtype=dtype, type=VarType.LOD_TENSOR_ARRAY)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write", input=x)
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", input=array)
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", input=array)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def lod_rank_table(x, level=0, length=None):
    """Descending-length sort table over a padded batch (reference:
    layers/control_flow.py lod_rank_table / lod_rank_table_op.cc). ``length``
    is the dense-layout [B] length vector; None means full length."""
    helper = LayerHelper("lod_rank_table", input=x)
    table = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_rank_table"),
        type=VarType.LOD_RANK_TABLE)
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="lod_rank_table", inputs=ins,
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_length", input=rank_table)
    res = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [res]})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array", input=x)
    array = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_tensor_to_array"),
        type=VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor", input=x)
    tmp = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [tmp]})
    return tmp


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper("split_lod_tensor", input=input)
    out_true = helper.create_variable_for_type_inference(input.dtype)
    out_false = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                     attrs={"level": level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper("merge_lod_tensor", input=x)
    out = helper.create_variable_for_type_inference(
        in_true.dtype if in_true is not None else in_false.dtype)
    empty = "@EMPTY@"
    helper.append_op(type="merge_lod_tensor",
                     inputs={"X": [x], "Mask": [mask],
                             "InTrue": [in_true if in_true is not None
                                        else empty],
                             "InFalse": [in_false if in_false is not None
                                         else empty]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


class BlockGuard(object):
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return exc_type is None


class While(object):
    """Static while loop building a sub-block (reference:
    control_flow.py While / controlflow/while_op.cc:43).

    ``max_trip_count`` (the JAX package's extension): a bound on the trips,
    needed when gradients flow through the loop, whose grad op replays at
    most that many trips (the reference's WhileGradOp keeps StepScopes,
    while_op.cc:118). For the counter loop ``i = const; while i < const:
    i += const`` the bound is inferred and the argument may be left out."""

    def __init__(self, cond, is_test=False, name=None, max_trip_count=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_trip_count = max_trip_count

    def block(self):
        return WhileGuard(self)


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super(WhileGuard, self).__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        return super(WhileGuard, self).__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        program = self.while_op.helper.main_program
        sub_block = program.current_block()
        parent = program.block(sub_block.parent_idx)
        # externally-defined vars read/written inside become loop-carried state
        inner_reads, inner_writes = set(), set()
        for op in sub_block.ops:
            inner_reads.update(op.input_arg_names)
            inner_writes.update(op.output_arg_names)
        external = sorted(
            n for n in (inner_reads | inner_writes)
            if not sub_block.has_var(n) and parent._has_var_recursive(n))
        ret = super(WhileGuard, self).__exit__(exc_type, exc_val, exc_tb)
        parent.append_op(
            type="while",
            inputs={"Condition": [self.while_op.cond_var.name], "X": external},
            outputs={"Out": external, "StepScopes": []},
            attrs={"sub_block": sub_block.idx, "is_test": False,
                   "max_trip_count": self.while_op.max_trip_count or 0})
        return ret


class Go(object):
    """Spawn a sub-block onto a host thread, goroutine-style (reference:
    operators/csp/go_op.cc:110, the experimental CSP op).

    The block's reads of enclosing variables become the ``go`` op's inputs;
    the block runs over a child scope, so its writes never race the parent
    program, on a copy of its inputs taken when the op runs.
    ``Executor.go_join()`` waits for the spawned blocks and returns their
    child scopes (the JAX package's extension of the reference's detached
    thread).

        with fluid.layers.Go().block():
            heavy_side_computation(x)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("go", name=name)

    def block(self):
        return GoGuard(self)


class GoGuard(BlockGuard):
    def __init__(self, go_op):
        super(GoGuard, self).__init__(go_op.helper.main_program)
        self.go_op = go_op

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        program = self.go_op.helper.main_program
        sub_block = program.current_block()
        parent = program.block(sub_block.parent_idx)
        inner_reads = set()
        for op in sub_block.ops:
            inner_reads.update(op.input_arg_names)
        external = sorted(
            n for n in inner_reads
            if not sub_block.has_var(n) and parent._has_var_recursive(n))
        ret = super(GoGuard, self).__exit__(exc_type, exc_val, exc_tb)
        parent.append_op(
            type="go", inputs={"X": external}, outputs={},
            attrs={"sub_block": sub_block.idx})
        return ret


class Switch(object):
    """Switch/case built from conditional blocks (reference: control_flow.py
    Switch:1126). Cases are made mutually exclusive exactly as the reference
    does: case k runs under ``not(c_1) & ... & not(c_{k-1}) & c_k`` and
    default under ``not(c_1) & ... & not(c_n)`` — first match wins."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []

    def _logical(self):
        from . import nn as nn_layers
        return nn_layers.logical_and, nn_layers.logical_not

    def case(self, condition):
        logical_and, logical_not = self._logical()
        if not self.pre_not_conditions:
            eff = condition
            self.pre_not_conditions.append(logical_not(condition))
        else:
            pre = self.pre_not_conditions[-1]
            eff = logical_and(pre, condition)
            self.pre_not_conditions.append(
                logical_and(pre, logical_not(condition)))
        return _SwitchCaseGuard(self, eff)

    def default(self):
        if not self.pre_not_conditions:
            return _SwitchCaseGuard(self, None)
        return _SwitchCaseGuard(self, self.pre_not_conditions[-1])

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return exc_type is None


class _SwitchCaseGuard(BlockGuard):
    def __init__(self, switch, condition):
        super(_SwitchCaseGuard, self).__init__(switch.helper.main_program)
        self.switch = switch
        self.condition = condition

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        program = self.switch.helper.main_program
        sub_block = program.current_block()
        parent = program.block(sub_block.parent_idx)
        inner_reads, inner_writes = set(), set()
        for op in sub_block.ops:
            inner_reads.update(op.input_arg_names)
            inner_writes.update(op.output_arg_names)
        external_out = sorted(n for n in inner_writes
                              if not sub_block.has_var(n)
                              and parent._has_var_recursive(n))
        # written vars are implicit READS too: the untaken branch passes the
        # pre-block value through (scope semantics of the reference
        # ConditionalBlockOp) — and the backward pass needs that identity
        # path, so they must be listed as inputs
        external_in = sorted(set(
            n for n in inner_reads
            if not sub_block.has_var(n)
            and parent._has_var_recursive(n)) | set(external_out))
        ret = super(_SwitchCaseGuard, self).__exit__(exc_type, exc_val, exc_tb)
        cond_name = [self.condition.name] if self.condition is not None else []
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": cond_name, "Input": external_in},
            outputs={"Out": external_out, "Scope": []},
            attrs={"sub_block": sub_block.idx,
                   "is_scalar_condition": True})
        return ret


class StaticRNN(object):
    """Step-block RNN (reference: control_flow.py StaticRNN + RecurrentOp,
    recurrent_op.cc:53). The step block records ops on a sub-block; on exit
    one `recurrent` op is appended that carries them and runs them over
    the time steps (ops/rnn_ops.py); its gradient is a ``grad_of``.

    Usage (padded [B, T, D] inputs):
        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)                 # [B, D]
            h_prev = rnn.memory(shape=(-1, H))      # or init=<var>
            h = fluid.layers.fc(input=[x_t, h_prev], size=H, act='tanh', ...)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                                 # [B, T, H]
    """

    def __init__(self, name=None, length=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._step_inputs = []   # (parent var, inner var)
        self._memories = []      # dict: inner prev var -> (boot var, new var)
        self._mem_list = []      # (boot, prev) in creation order
        self._updates = {}       # prev name -> new var
        self._outputs = []       # (inner var, outer var)
        self._sub_block = None
        self._parent_block = None
        self._done = False
        self._length = length

    def step(self):
        return _StaticRNNGuard(self)

    def step_input(self, x):
        sub = self._sub_block
        inner = sub.create_var(
            name=unique_name.generate(self.helper.name + ".step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, value=None,
               dtype="float32"):
        # reference order: (init, shape, batch_ref, init_value, ...);
        # `value` kept as an alias for this build's earlier keyword form
        value = init_value if value is None else value
        sub = self._sub_block
        if init is None:
            if shape is None:
                raise ValueError("memory needs init or shape")
            from . import tensor as tensor_layers
            # boot value must live in the parent block (it is evaluated in the
            # parent env and fed to the scan as the initial carry)
            program = self.helper.main_program
            prev_idx = program.current_block_idx
            program.current_block_idx = self._parent_block.idx
            try:
                if batch_ref is not None:
                    # reference code passes the STEP input as batch_ref; the
                    # boot lives in the parent block, so substitute the
                    # step input's source sequence (same batch dim)
                    for outer, inner in self._step_inputs:
                        if batch_ref is inner:
                            batch_ref = outer
                            break
                    boot = tensor_layers.fill_constant_batch_size_like(
                        batch_ref, list(shape), dtype, value)
                else:
                    boot = tensor_layers.fill_constant(
                        [abs(s) for s in shape], dtype, value)
            finally:
                program.current_block_idx = prev_idx
        else:
            boot = init
        prev = sub.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            shape=boot.shape, dtype=boot.dtype)
        self._mem_list.append((boot, prev))
        return prev

    def update_memory(self, mem, var):
        self._updates[mem.name] = var

    def step_output(self, o):
        outer = self._parent_block.create_var(
            name=unique_name.generate(self.helper.name + ".out"),
            dtype=o.dtype)
        self._outputs.append((o, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self, *args, **kwargs):
        outs = [outer for _, outer in self._outputs]
        return outs[0] if len(outs) == 1 else outs

    def _complete(self):
        program = self.helper.main_program
        sub = self._sub_block
        parent = self._parent_block
        inner_defined = set(sub.vars.keys())
        inner_written = set()
        reads = set()
        for op in sub.ops:
            reads.update(op.input_arg_names)
            inner_written.update(op.output_arg_names)
        step_var_names = [iv.name for _, iv in self._step_inputs]
        mem_prev = [p.name for _, p in self._mem_list]
        params = sorted(
            n for n in reads
            if n not in inner_defined and n not in inner_written
            and parent._has_var_recursive(n) and n != "@EMPTY@")
        mem_new = []
        for boot, prev in self._mem_list:
            if prev.name not in self._updates:
                raise ValueError("memory %r never updated" % prev.name)
            mem_new.append(self._updates[prev.name].name)
        inputs = {
            "StepInputs": [x.name for x, _ in self._step_inputs],
            "Boot": [b.name for b, _ in self._mem_list],
            "Params": params,
        }
        length = self._length
        if length is None and self._step_inputs:
            length = get_sequence_length(self._step_inputs[0][0])
        if length is not None:
            inputs["Length"] = [length.name if hasattr(length, "name")
                                else length]
        finals = []
        for boot, prev in self._mem_list:
            fv = parent.create_var(
                name=unique_name.generate(self.helper.name + ".final"),
                shape=boot.shape, dtype=boot.dtype)
            finals.append(fv.name)
        op = parent.append_op(
            type="recurrent",
            inputs=inputs,
            outputs={"Out": [outer.name for _, outer in self._outputs],
                     "FinalState": finals},
            attrs={"sub_ops_desc": [o.to_dict() for o in sub.ops],
                   "step_vars": step_var_names,
                   "param_names": params,
                   "mem_prev": mem_prev,
                   "mem_new": mem_new,
                   "step_out_inner": [i.name for i, _ in self._outputs],
                   "reverse": False})
        # shapes: outer out = [B, T, ...inner]
        t_dim = self._step_inputs[0][0].shape[1] if self._step_inputs else None
        for inner, outer in self._outputs:
            if inner.shape is not None:
                outer.shape = (inner.shape[0], t_dim) + tuple(inner.shape[1:])
        self._done = True
        return op


class _StaticRNNGuard(BlockGuard):
    def __init__(self, rnn):
        super(_StaticRNNGuard, self).__init__(rnn.helper.main_program)
        self.rnn = rnn

    def __enter__(self):
        super(_StaticRNNGuard, self).__enter__()
        self.rnn._sub_block = self.main_program.current_block()
        self.rnn._parent_block = self.main_program.block(
            self.rnn._sub_block.parent_idx)
        return self.rnn

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        ret = super(_StaticRNNGuard, self).__exit__(exc_type, exc_val, exc_tb)
        self.rnn._complete()
        return ret


class DynamicRNN(object):
    """Ragged-batch RNN (reference: control_flow.py DynamicRNN over LoD rank
    tables). Padded-layout equivalent of StaticRNN: lengths mask the carried
    state so each example's memory freezes past its own length, in place of
    the reference's rank-table shrinking. The lengths are those of the
    first ragged step input (its ``seq_length_var``)."""

    def __init__(self, name=None):
        self._rnn = None
        self._name = name
        self._length = None

    def block(self):
        self._rnn = StaticRNN(name=self._name, length=self._length)
        outer = self

        class _Guard(_StaticRNNGuard):
            def __enter__(self):
                rnn = super(_Guard, self).__enter__()
                return outer
        return _Guard(self._rnn)

    def step_input(self, x, level=0):
        if self._length is None:
            l = get_sequence_length(x)
            if l is not None:
                self._length = l
                self._rnn._length = l
        return self._rnn.step_input(x)

    def static_input(self, x):
        return x

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False, batch_ref=None):
        return self._rnn.memory(init=init, shape=shape, value=value,
                                dtype=dtype, batch_ref=batch_ref)

    def update_memory(self, ex_mem, new_mem):
        return self._rnn.update_memory(ex_mem, new_mem)

    def output(self, *outputs):
        return self._rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        return self._rnn(*args, **kwargs)


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print op (reference print_op.cc): a host op; the executor prints
    the value and passes it on."""
    helper = LayerHelper("print", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n, "message": message or "",
                            "summarize": summarize,
                            "print_phase": print_phase})
    return out


class IfElse(object):
    """Row-wise two-branch computation (reference layers/control_flow.py
    IfElse: splits rows by a boolean cond, runs each branch on its subset,
    merges).

    As in the JAX package both branches are built into the same block over
    the full batch and merged by a row-wise select on the cond mask: the
    same results for the per-row nets IfElse supports, with static shapes
    (the reference's gather and scatter make a batch of data-dependent
    size). Both branches compute on every row."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.cond = cond
        self._branch = None       # True / False while inside a block
        self._outputs = {True: [], False: []}

    class _BlockGuard(object):
        def __init__(self, ie, branch):
            self.ie = ie
            self.branch = branch

        def __enter__(self):
            self.ie._branch = self.branch
            return self.ie

        def __exit__(self, *a):
            self.ie._branch = None
            return False

    def true_block(self):
        return IfElse._BlockGuard(self, True)

    def false_block(self):
        return IfElse._BlockGuard(self, False)

    def input(self, x):
        if self._branch is None:
            raise RuntimeError("IfElse.input() outside a branch block")
        return x

    def output(self, *outs):
        if self._branch is None:
            raise RuntimeError("IfElse.output() outside a branch block")
        self._outputs[self._branch].extend(outs)

    def __call__(self):
        t, f = self._outputs[True], self._outputs[False]
        if len(t) != len(f):
            raise ValueError(
                "IfElse branches declared different output counts "
                "(%d vs %d)" % (len(t), len(f)))
        from . import nn as nn_layers
        from . import tensor as tensor_layers
        merged = []
        for tv, fv in zip(t, f):
            # rowwise select: where(cond, true_val, false_val)
            cond = tensor_layers.cast(self.cond, tv.dtype)
            merged.append(nn_layers.elementwise_add(
                nn_layers.elementwise_mul(tv, cond),
                nn_layers.elementwise_mul(
                    fv, nn_layers.elementwise_sub(
                        tensor_layers.fill_constant(
                            shape=[1], dtype=tv.dtype, value=1.0), cond))))
        return merged
