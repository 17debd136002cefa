"""Inference-time program rewrites.

Reference parity: python/paddle/fluid/transpiler/inference_transpiler.py
(InferenceTranspiler:25 — _fuse_batch_norm:306, _is_test_pass:84).

The port's copy of ``paddle_tpu/fluid/transpiler/inference_transpiler.py``,
with the same two rewrites, which change the program, not the schedule:

- is_test pass: dropout/batch_norm flipped to inference behavior;
- conv+bn fold: batch_norm collapses into the conv weights/bias
  algebraically (W' = W·γ/√(σ²+ε) per out-channel), removing the op and
  its four statistic tensors from the graph entirely.

The folded filter and bias are computed on the host in numpy float32, as
the JAX transpiler computes them, so they are bit for bit its values; each
is written back to the scope on the device of the tensor it replaces, in
its variable's dtype. The rewrite bumps the program's version, so an
Executor that ran the program plans it anew.
"""
import numpy as np
import torch

from ..core_types import to_torch_dtype
from ..executor import as_numpy

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler(object):
    """Rewrite a trained inference program in place.

    Example:
        t = fluid.transpiler.InferenceTranspiler()
        t.transpile(inference_program, place, scope=fluid.global_scope())
    """

    def transpile(self, program, place, scope=None):
        from ..executor import global_scope
        from ..framework import Program
        if not isinstance(program, Program):
            raise TypeError("argument program should be a Program")
        scope = scope if scope is not None else global_scope()
        self._is_test_pass(program)
        self._fuse_batch_norm(program, place, scope)
        program._bump_version()

    # -- passes ------------------------------------------------------------

    def _is_test_pass(self, program):
        """Flip train-only ops to inference mode (reference :84)."""
        for op in program.global_block().ops:
            if op.type in ("dropout", "batch_norm"):
                op.attrs["is_test"] = True

    def _fuse_batch_norm(self, program, place, scope):
        """Fold batch_norm into the preceding conv (reference :306).

        Handles conv2d -> batch_norm and conv2d -> elementwise_add(bias)
        -> batch_norm. The bn statistics are read from `scope`, folded
        into the conv filter (and a bias that is created when absent),
        and the bn op is deleted with its output rewired.
        """
        block = program.global_block()
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type != "batch_norm":
                i += 1
                continue
            x_name = op.input("X")[0]
            producer_idx, producer = self._producer(block, i, x_name)
            conv_op, bias_op = None, None
            if producer is not None and producer.type in (
                    "conv2d", "depthwise_conv2d"):
                conv_op = producer
            elif producer is not None and producer.type == "elementwise_add":
                up_idx, up = self._producer(block, producer_idx,
                                            producer.input("X")[0])
                if up is not None and up.type in ("conv2d",
                                                  "depthwise_conv2d"):
                    conv_op, bias_op = up, producer
            if conv_op is None or self._n_consumers(block, x_name) > 1:
                i += 1
                continue

            eps = float(op.attrs.get("epsilon", 1e-5))
            scale = self._load(scope, op.input("Scale")[0])
            bn_bias = self._load(scope, op.input("Bias")[0])
            mean = self._load(scope, op.input("Mean")[0])
            var = self._load(scope, op.input("Variance")[0])
            alpha = scale / np.sqrt(var + eps)

            w_name = conv_op.input("Filter")[0]
            w = self._load(scope, w_name)
            device = scope.get(w_name).device
            self._store(scope, block, w_name,
                        (w * alpha.reshape(-1, 1, 1, 1)).astype(w.dtype),
                        device)

            y_name = op.output("Y")[0]
            if bias_op is not None:
                b_name = bias_op.input("Y")[0]
                b = self._load(scope, b_name)
                self._store(scope, block, b_name,
                            ((b - mean) * alpha + bn_bias).astype(b.dtype),
                            device)
                # the bias add now produces the bn output directly
                bias_op.outputs["Out"] = [y_name]
                block.remove_op(i)
            else:
                b_name = y_name + ".fused_bn_bias"
                bvar = block.create_var(name=b_name,
                                        shape=[int(alpha.shape[0])],
                                        dtype="float32")
                bvar.persistable = True
                self._store(scope, block, b_name,
                            ((0.0 - mean) * alpha + bn_bias).astype(
                                "float32"), device)
                block.remove_op(i)
                block.insert_op(
                    i, type="elementwise_add",
                    inputs={"X": [conv_op.output("Output")[0]],
                            "Y": [b_name]},
                    outputs={"Out": [y_name]}, attrs={"axis": 1})
            # keep scanning from the same index — ops shifted
        self._prune_dead_vars(program)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _producer(block, before_idx, var_name):
        for j in range(before_idx - 1, -1, -1):
            if var_name in block.ops[j].output_arg_names:
                return j, block.ops[j]
        return None, None

    @staticmethod
    def _n_consumers(block, var_name):
        return sum(1 for o in block.ops if var_name in o.input_arg_names)

    @staticmethod
    def _load(scope, name):
        v = scope.get(name)
        if v is None:
            raise RuntimeError(
                "variable %r has no value in scope — run the startup "
                "program / load parameters before transpiling" % name)
        return np.asarray(as_numpy(v), "float32")

    @staticmethod
    def _store(scope, block, name, value, device):
        """A folded numpy value into the scope on `device`, in the dtype
        its variable declares."""
        meta = block.vars.get(name)
        dtype = to_torch_dtype(meta.dtype) if meta is not None and \
            meta.dtype else torch.float32
        scope.set(name, torch.from_numpy(np.ascontiguousarray(value)).to(
            device=device, dtype=dtype))

    @staticmethod
    def _prune_dead_vars(program):
        """Drop vars no op references anymore (the bn statistics),
        mirroring the reference's remove_unused_var pass."""
        block = program.global_block()
        used = set()
        for op in block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        for name in list(block.vars):
            if name not in used and not block.vars[name].persistable:
                del block.vars[name]
            elif name not in used and name != "feed" and name != "fetch":
                # bn statistic params are persistable but now dead
                del block.vars[name]
