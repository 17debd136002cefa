"""Legacy Evaluator API (the port's counterpart of
``paddle_tpu/fluid/evaluator.py``; reference: python/paddle/fluid/
evaluator.py, deprecated there in favour of fluid.metrics). Accumulator
state lives in persistable variables that the program updates itself:
EditDistance sums each batch's distances, sequence count and errors into
them on the device, and ``eval`` reads the sums from the scope.
ChunkEvaluator (``chunk_eval``) and DetectionMAP (``detection_map``) wait
for ROADMAP Queue 1 item 6: they raise."""
import numpy as np
import torch

from .executor import as_numpy, global_scope
from .layer_helper import LayerHelper
from .initializer import Constant
from .core_types import to_torch_dtype
from . import layers as fluid_layers

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP", "Evaluator"]


class Evaluator(object):
    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []

    def reset(self, executor, reset_program=None):
        """Zero every state in the global scope, on the device its value
        lies on (the executor's for a state not run yet)."""
        scope = global_scope()
        for var in self.states:
            old = scope.get(var.name)
            device = old.device if old is not None else executor.device
            scope.set(var.name, torch.zeros(
                [abs(d) for d in (var.shape or (1,))],
                dtype=to_torch_dtype(var.dtype or "float32"), device=device))

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def _create_state(self, suffix, dtype, shape):
        var = self.helper.create_global_variable(
            name="_".join([self.helper.name, suffix]), persistable=True,
            dtype=dtype, shape=list(shape))
        self.helper.set_variable_initializer(var, Constant(0.0))
        self.states.append(var)
        return var


class ChunkEvaluator(Evaluator):
    """Chunk F1 over the chunk_eval op's counts waits for ROADMAP Queue 1
    item 6 (``parity_ops.py``'s chunk_eval)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        raise NotImplementedError(
            "evaluator.ChunkEvaluator builds chunk_eval, which waits for "
            "ROADMAP Queue 1 item 6 (parity_ops.py)")


class EditDistance(Evaluator):
    """Average edit distance and instance error rate accumulated across
    minibatches (reference evaluator.py EditDistance:206). The
    edit_distance op gets no lengths, as in the JAX package: each padded
    row counts whole."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super(EditDistance, self).__init__("edit_distance")
        self.total_distance = self._create_state(
            "total_distance", "float32", [1])
        self.seq_num = self._create_state("seq_num", "int64", [1])
        self.instance_error = self._create_state(
            "instance_error", "int64", [1])
        distances, seq_num = fluid_layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        zero = fluid_layers.fill_constant(shape=[1], dtype="float32",
                                          value=0.0)
        errors = fluid_layers.reduce_sum(
            fluid_layers.cast(fluid_layers.greater_than(distances, zero),
                              "int64"))
        batch_total = fluid_layers.reduce_sum(distances)
        fluid_layers.sums([self.total_distance, batch_total],
                          out=self.total_distance)
        fluid_layers.sums([self.seq_num, seq_num], out=self.seq_num)
        fluid_layers.sums([self.instance_error, errors],
                          out=self.instance_error)
        self.metrics = [distances, seq_num]

    def eval(self, executor, eval_program=None):
        """(average distance, instance error rate), each float32 [1], from
        the states in the global scope."""
        scope = global_scope()
        total = float(as_numpy(scope.get(self.total_distance.name)).sum())
        n = float(as_numpy(scope.get(self.seq_num.name)).sum())
        err = float(as_numpy(scope.get(self.instance_error.name)).sum())
        avg = total / n if n else 0.0
        inst_err = err / n if n else 0.0
        return (np.asarray([avg], "float32"),
                np.asarray([inst_err], "float32"))


class DetectionMAP(Evaluator):
    """Detection mAP over the detection_map op's states waits for ROADMAP
    Queue 1 item 6 (``detection_ops.py``)."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        raise NotImplementedError(
            "evaluator.DetectionMAP builds detection_map, which waits for "
            "ROADMAP Queue 1 item 6 (detection_ops.py)")
