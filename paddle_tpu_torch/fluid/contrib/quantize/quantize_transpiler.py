"""QuantizeTranspiler: rewrite a program for quantization-aware training
(the port's counterpart of ``paddle_tpu/fluid/contrib/quantize/
quantize_transpiler.py``; reference: python/paddle/fluid/contrib/quantize/
quantize_transpiler.py:81). ``training_transpile`` puts a fake
quantize(-dequantize) round trip on each distinct input and weight of the
quantizable ops (mul, conv2d, depthwise_conv2d), so that training sees the
quantization error while gradients pass straight through
(``ops/quantize_ops.py``).

As in the JAX package, the moving-average and range types read an
``InScale`` state that ``training_transpile`` does not pass: a program it
builds with them raises at its first run (ROADMAP Queue 3).
``freeze_program`` returns the test-mode clone; ``convert_to_int8`` stores
the weights as int8 on the host, in numpy, as the JAX package does.
"""
import numpy as np
import torch

from ... import unique_name
from ...core_types import OpRole

QUANTIZABLE_OPS = ("conv2d", "depthwise_conv2d", "mul")
_QUANT_SLOTS = {"conv2d": ("Input", "Filter"),
                "depthwise_conv2d": ("Input", "Filter"),
                "mul": ("X", "Y")}


class QuantizeTranspiler(object):
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate

    def _quant_op_type(self, kind):
        t = self.act_type if kind == "act" else self.weight_type
        if t == "abs_max":
            return "fake_quantize_dequantize_abs_max"
        if t == "moving_average_abs_max":
            return "fake_quantize_moving_average_abs_max"
        if t == "range_abs_max":
            return "fake_quantize_range_abs_max"
        raise ValueError("unknown quantize type %r" % t)

    def training_transpile(self, program=None, startup_program=None):
        """Insert a round trip before the first forward quantizable op that
        reads each input or weight, and make every such op read the
        round trip's output (one round trip a name: a block's first conv
        and its shortcut share theirs)."""
        from ...framework import Operator, default_main_program
        program = program or default_main_program()
        block = program.global_block()
        quantized = {}  # var name -> quantized var name
        new_ops = []
        for op in block.ops:
            if op.type in QUANTIZABLE_OPS and op.op_role == OpRole.Forward:
                for slot in _QUANT_SLOTS[op.type]:
                    names = op.input(slot)
                    if not names:
                        continue
                    src = names[0]
                    if src not in quantized:
                        qname = unique_name.generate(src + ".quantized")
                        sname = unique_name.generate(src + ".scale")
                        try:
                            v = block._var_recursive(src)
                            block.create_var(name=qname, shape=v.shape,
                                             dtype=v.dtype)
                            block.create_var(name=sname, shape=(1,),
                                             dtype="float32")
                        except ValueError:
                            block.create_var(name=qname)
                            block.create_var(name=sname)
                        is_weight = slot in ("Filter", "Y")
                        new_ops.append(Operator(
                            block, self._quant_op_type(
                                "weight" if is_weight else "act"),
                            {"X": [src]},
                            {"Out": [qname], "OutScale": [sname]},
                            {"bit_length": self.weight_bits if is_weight
                             else self.activation_bits,
                             "moving_rate": self.moving_rate}))
                        quantized[src] = qname
                    op.rename_input(src, quantized[src])
            new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
        return program

    def freeze_program(self, program, place=None, fuse_bn=False,
                       scope=None):
        """The inference freeze: the round trips already give dequantized
        values, so the test-mode clone serves as it is (kept for API
        parity, as in the JAX package)."""
        return program.clone(for_test=True)

    def convert_to_int8(self, program, place=None, scope=None):
        """Store each float parameter of two or more dims as int8 (the
        reference's convert_to_int8): the scope holds ``W@INT8`` on W's
        device in place of W, W becomes non-persistable, and the program
        gains a prepended cast and scale that recompute float W from it each
        run. The scale (max |W| / 127) and the int8 values are computed in
        numpy on the host, as the JAX package does. Returns the converted
        names."""
        from ...executor import as_numpy, global_scope
        from ...framework import Parameter
        scope = scope or global_scope()
        block = program.global_block()
        converted = []
        for var in list(block.vars.values()):
            if not isinstance(var, Parameter):
                continue
            val = scope.get(var.name)
            if val is None:
                continue
            a = as_numpy(val)
            if a.dtype not in (np.float32, np.float64) or a.ndim < 2:
                continue
            scale = float(np.max(np.abs(a))) / 127.0 or 1.0
            q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
            int8_name = var.name + "@INT8"
            block.create_var(name=int8_name, shape=list(a.shape),
                             dtype="int8", persistable=True)
            scope.set(int8_name, torch.from_numpy(q).to(val.device))
            scope.erase([var.name])
            var.persistable = False
            deq = var.name + "@DEQ"
            block.create_var(name=deq, shape=list(a.shape), dtype="float32")
            # prepended in reverse, so that the cast runs first
            block.prepend_op(type="scale", inputs={"X": [deq]},
                             outputs={"Out": [var.name]},
                             attrs={"scale": scale})
            block.prepend_op(type="cast", inputs={"X": [int8_name]},
                             outputs={"Out": [deq]},
                             attrs={"in_dtype": "int8",
                                    "out_dtype": "float32"})
            converted.append(var.name)
        return converted
