"""The Program/Block/Operator/Variable IR — the user-facing declarative graph.

The port's counterpart of ``paddle_tpu/fluid/framework.py``: the same
plain-Python IR (Variable, Parameter, Operator, Block, Program), the same
JSON-serializable form, ``clone(for_test=True)`` and ``_prune``, so a
Program built here is op-for-op identical to one the JAX package builds.
Below the IR the executor runs each op eagerly as PyTorch on one
``torch.device`` (see executor.py) instead of lowering the block to XLA.

Places are ``CPUPlace`` and ``CUDAPlace``; ``cuda_places()`` counts cards
with ``torch.cuda.device_count()``.
"""
import collections
import contextlib
import json

import numpy as np
import torch

from . import unique_name
from .core_types import VarType, OpRole, convert_dtype

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program",
    "switch_main_program", "switch_startup_program", "program_guard",
    "cpu_places", "cuda_places",
    "CPUPlace", "CUDAPlace", "GRAD_VAR_SUFFIX", "grad_var_name",
    "name_scope",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


_name_scope_stack = [""]


@contextlib.contextmanager
def name_scope(prefix=None):
    """Debug name scoping for ops (reference: framework.py name_scope): an
    op appended inside carries the scope's path in its ``name_scope``
    attr."""
    _name_scope_stack.append(
        (_name_scope_stack[-1] + "/" if _name_scope_stack[-1] else "") +
        (prefix or ""))
    try:
        yield
    finally:
        _name_scope_stack.pop()


class Variable(object):
    """A named tensor slot in a Block.

    Compile-time: name/shape/dtype/role metadata. The runtime value lives in
    a Scope (executor.py) as a torch tensor.
    """

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=None,
                 persistable=False, stop_gradient=False, type=VarType.LOD_TENSOR,
                 capacity=None, is_data=False, need_check_feed=False, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.error_clip = kwargs.get("error_clip", None)

    # ---- serialization ----
    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }

    @staticmethod
    def from_dict(block, d):
        if d.get("is_parameter"):
            var = Parameter(block, name=d["name"], shape=d["shape"], dtype=d["dtype"],
                            lod_level=d.get("lod_level", 0),
                            trainable=d.get("trainable", True))
        else:
            var = Variable(block, name=d["name"], shape=d["shape"], dtype=d["dtype"],
                           lod_level=d.get("lod_level", 0),
                           persistable=d.get("persistable", False),
                           stop_gradient=d.get("stop_gradient", False),
                           type=d.get("type", VarType.LOD_TENSOR),
                           is_data=d.get("is_data", False))
        return var

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    # operator sugar: `a + b`, `1.0 - p`, `step ** -0.5`, `a < b` append
    # elementwise and compare ops whose output takes the left Variable's
    # dtype (layers/math_op_patch.py); there is no __eq__, as in the JAX
    # package, so Variables stay hashable and compare by identity
    def _binary(self, other, op):
        from .layers import math_op_patch
        return math_op_patch.binary(self, other, op)

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add")
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub_r")
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul")
    def __div__(self, o): return self._binary(o, "elementwise_div")
    def __truediv__(self, o): return self._binary(o, "elementwise_div")
    def __rdiv__(self, o): return self._binary(o, "elementwise_div_r")
    def __rtruediv__(self, o): return self._binary(o, "elementwise_div_r")
    def __pow__(self, o): return self._binary(o, "elementwise_pow")
    def __rpow__(self, o): return self._binary(o, "elementwise_pow_r")
    def __neg__(self): return self._binary(-1.0, "elementwise_mul")
    def __lt__(self, o): return self._binary(o, "less_than")
    def __le__(self, o): return self._binary(o, "less_equal")
    def __gt__(self, o): return self._binary(o, "greater_than")
    def __ge__(self, o): return self._binary(o, "greater_equal")


class Parameter(Variable):
    """A persistable, trainable Variable (reference: framework.py Parameter:3077)."""

    def __init__(self, block, shape, dtype, name=None, trainable=True,
                 optimize_attr=None, regularizer=None, gradient_clip_attr=None,
                 do_model_average=False, **kwargs):
        super(Parameter, self).__init__(
            block, name=name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=not trainable, **kwargs)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        self.is_distributed = False

    def __repr__(self):
        return "Parameter(%s, shape=%s, dtype=%s)" % (self.name, self.shape, self.dtype)

    __str__ = __repr__


class Operator(object):
    """One IR node: op type, named input/output slots (each a list of var
    names), attrs. The lowering registry (ops/registry.py) is the single
    source of op semantics."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = self._canon(inputs)
        self.outputs = self._canon(outputs)
        self.attrs = dict(attrs) if attrs else {}
        if OpRole.KEY not in self.attrs:
            self.attrs[OpRole.KEY] = OpRole.Forward
        if _name_scope_stack[-1]:
            self.attrs.setdefault("name_scope", _name_scope_stack[-1])

    @staticmethod
    def _canon(io):
        out = collections.OrderedDict()
        if not io:
            return out
        for slot, vs in io.items():
            if vs is None:
                out[slot] = []
                continue
            if not isinstance(vs, (list, tuple)):
                vs = [vs]
            names = []
            for v in vs:
                if v is None:
                    continue
                if isinstance(v, Variable):
                    names.append(v.name)
                elif isinstance(v, str):
                    names.append(v)
                elif isinstance(v, bytes):
                    names.append(v.decode())
                else:
                    raise TypeError(
                        "op slot %r got a %s, not a Variable/name. "
                        "fluid.layers.* build graph Programs; run them with "
                        "an Executor" % (slot, type(v).__name__))
            out[slot] = names
        return out

    # ---- slot access ----
    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def rename_input(self, old, new):
        """Read `new` wherever this op reads `old`."""
        for slot, vs in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in vs]
        self.block.program._bump_version()

    @property
    def op_role(self):
        return self.attrs.get(OpRole.KEY, OpRole.Forward)

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            elif isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            else:
                attrs[k] = v
        return {"type": self.type, "inputs": dict(self.inputs),
                "outputs": dict(self.outputs), "attrs": attrs}

    @staticmethod
    def from_dict(block, d):
        attrs = {}
        for k, v in d.get("attrs", {}).items():
            if isinstance(v, dict) and "__ndarray__" in v:
                attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
            elif isinstance(v, dict) and "__block__" in v:
                attrs[k] = v["__block__"]
            else:
                attrs[k] = v
        return Operator(block, d["type"], d.get("inputs"), d.get("outputs"), attrs)

    def __repr__(self):
        ins = ", ".join("%s=%s" % (k, v) for k, v in self.inputs.items())
        outs = ", ".join("%s=%s" % (k, v) for k, v in self.outputs.items())
        return "{%s} = %s(%s)" % (outs, self.type, ins)

    __str__ = __repr__


class Block(object):
    """Ordered op list + var table; nested via parent_idx (reference: Block:1148)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # ---- vars ----
    def create_var(self, **kwargs):
        name = kwargs.get("name", None)
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, **kwargs)
        # parameters always live in the global block, like the reference
        gb = self.program.global_block()
        gb.vars[param.name] = param
        param.block = gb
        self.program._bump_version()
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _var_recursive(self, name):
        """Find var here or in any ancestor block."""
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError("variable %r not found in block %d or ancestors"
                         % (name, self.idx))

    def _has_var_recursive(self, name):
        try:
            self._var_recursive(name)
            return True
        except ValueError:
            return False

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # ---- ops ----
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.insert_op(0, type, inputs, outputs, attrs)

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        self.ops.pop(index)
        self.program._bump_version()

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "forward_block_idx": self.forward_block_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}

    def __repr__(self):
        lines = ["block %d (parent %d):" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__


class Program(object):
    """A whole computation: list of Blocks, block 0 global (reference:
    Program:2444). Carries a monotone ``version`` bumped on every mutation."""

    _id_counter = 0

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self.version = 0
        self._is_test = False
        Program._id_counter += 1
        self.id = Program._id_counter
        # side-band metadata serialized with the program's JSON form and
        # carried by clone: the int8 Calibrator's per-tensor scales
        self._dist_attrs = {}

    def _bump_version(self):
        self.version += 1

    # ---- blocks ----
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, index):
        return self.blocks[index]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def create_block(self, parent_idx=None):
        """Append a block whose parent is ``parent_idx`` (the current block
        by default) and make it the current block: the sub-block of a
        While, a Switch case or a StaticRNN step."""
        prev = self.current_block_idx
        parent = prev if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def rollback(self):
        """Make the current block's parent the current block again."""
        self.current_block_idx = self.current_block().parent_idx
        self._bump_version()

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    # ---- clone / prune ----
    def clone(self, for_test=False):
        """Deep copy. for_test=True flips is_test on ops that behave differently at
        inference (dropout, batch_norm, ...) and strips optimizer/backward ops."""
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        if for_test:
            for b in p.blocks:
                b.ops = [op for op in b.ops
                         if op.op_role not in (OpRole.Backward, OpRole.Optimize,
                                               OpRole.Backward | OpRole.Loss)]
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
            p._is_test = True
        return p

    def _prune(self, feeds, fetches):
        """Keep only ops needed to compute `fetches` from `feeds` (inference save).

        Reverse-reachability over the global block, like the reference's Prune()
        (framework/prune.cc) but on the Python IR.
        """
        feeds = set(feeds)
        needed = set(fetches)
        gb = self.global_block()
        kept = []
        for op in reversed(gb.ops):
            if any(o in needed for o in op.output_arg_names):
                kept.append(op)
                for i in op.input_arg_names:
                    if i not in feeds:
                        needed.add(i)
        kept.reverse()
        p = self.clone()
        pgb = p.global_block()
        keep_sigs = [(op.type, json.dumps(op.to_dict(), sort_keys=True, default=str))
                     for op in kept]
        sig_count = collections.Counter(keep_sigs)
        new_ops = []
        for op in pgb.ops:
            sig = (op.type, json.dumps(op.to_dict(), sort_keys=True, default=str))
            if sig_count.get(sig, 0) > 0:
                sig_count[sig] -= 1
                new_ops.append(op)
        pgb.ops = new_ops
        used = set()
        for op in pgb.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        used |= feeds | set(fetches)
        pgb.vars = collections.OrderedDict(
            (n, v) for n, v in pgb.vars.items() if n in used)
        return p

    # ---- serialization ----
    def to_dict(self):
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks],
                "dist_attrs": self._dist_attrs}

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p._dist_attrs = dict(d.get("dist_attrs", {}))
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd.get("parent_idx", -1))
            b.forward_block_idx = bd.get("forward_block_idx", -1)
            for vd in bd.get("vars", []):
                v = Variable.from_dict(b, vd)
                b.vars[v.name] = v
            p.blocks.append(b)
        for b, bd in zip(p.blocks, d["blocks"]):
            for od in bd.get("ops", []):
                b.ops.append(Operator.from_dict(b, od))
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        p.current_block_idx = 0
        return p

    def serialize_to_string(self):
        """framework.proto wire bytes, the reference's model-file format
        (proto/program_desc.py), byte for byte what the JAX package writes
        for the same Program."""
        from .proto import program_to_bytes
        return program_to_bytes(self)

    def serialize_to_json(self):
        """The JSON debug form (to_dict), which parse_from_string reads."""
        return json.dumps(self.to_dict(), default=_json_default).encode("utf-8")

    @staticmethod
    def parse_from_string(binary_str):
        """Accepts framework.proto bytes (the model-file format) or the JSON
        debug form (auto-detected: a ProgramDesc never starts with '{' — tag
        0x7b would be field 15 group-start, absent from the schema). The
        proto form carries no Parameter flag: its vars come back as
        Variables, as in the JAX package."""
        if isinstance(binary_str, str):
            binary_str = binary_str.encode("utf-8")
        if binary_str[:1] == b"{":
            return Program.from_dict(json.loads(binary_str.decode("utf-8")))
        from .proto import program_from_bytes
        return program_from_bytes(binary_str)

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


def _json_default(o):
    if isinstance(o, np.ndarray):
        return {"__ndarray__": o.tolist(), "dtype": str(o.dtype)}
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError("not JSON-serializable: %r" % (o,))


# ---- default programs ----
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


# ---- places: each names one torch.device ----
class Place(object):
    kind = "cpu"

    def __init__(self, device_id=0):
        self.device_id = device_id

    def torch_device(self):
        return torch.device(self.kind, self.device_id) if self.kind == "cuda" \
            else torch.device("cpu")

    def __repr__(self):
        return "%sPlace(%d)" % (self.kind.upper(), self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((self.kind, self.device_id))


class CPUPlace(Place):
    kind = "cpu"


class CUDAPlace(Place):
    kind = "cuda"


def cpu_places(device_count=None):
    return [CPUPlace(0)]


def cuda_places(device_ids=None):
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]
