"""Legacy Evaluator API (the port's counterpart of
``paddle_tpu/fluid/evaluator.py``; reference: python/paddle/fluid/
evaluator.py, deprecated there in favour of fluid.metrics). Accumulator
state lives in persistable variables that the program updates itself:
EditDistance sums each batch's distances, sequence count and errors into
them on the device, and ``eval`` reads the sums from the scope;
DetectionMAP's detection_map host op carries its per-class counts and
scored matches from run to run; ChunkEvaluator sums the chunk_eval op's
three counts into its states on the device."""
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
    """Chunk (NER span) F1 accumulated across minibatches by in-program
    sums over the chunk_eval op's counts (reference evaluator.py
    ChunkEvaluator:120). chunk_eval gets no lengths, as in the JAX
    package: a padded tail is scored as tags."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super(ChunkEvaluator, self).__init__("chunk_eval")
        self.num_infer_chunks = self._create_state(
            "num_infer_chunks", "int64", [1])
        self.num_label_chunks = self._create_state(
            "num_label_chunks", "int64", [1])
        self.num_correct_chunks = self._create_state(
            "num_correct_chunks", "int64", [1])
        (precision, recall, f1, num_infer, num_label,
         num_correct) = fluid_layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        fluid_layers.sums([self.num_infer_chunks, num_infer],
                          out=self.num_infer_chunks)
        fluid_layers.sums([self.num_label_chunks, num_label],
                          out=self.num_label_chunks)
        fluid_layers.sums([self.num_correct_chunks, num_correct],
                          out=self.num_correct_chunks)
        self.metrics = [precision, recall, f1]

    def eval(self, executor, eval_program=None):
        """(precision, recall, f1), each float32 [1], from the states in
        the global scope."""
        scope = global_scope()
        ni = float(as_numpy(scope.get(self.num_infer_chunks.name)).sum())
        nl = float(as_numpy(scope.get(self.num_label_chunks.name)).sum())
        nc = float(as_numpy(scope.get(self.num_correct_chunks.name)).sum())
        precision = nc / ni if ni else 0.0
        recall = nc / nl if nl else 0.0
        f1 = (2.0 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return (np.asarray([precision], "float32"),
                np.asarray([recall], "float32"),
                np.asarray([f1], "float32"))


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
    """Detection mean average precision, per batch and accumulated
    (reference evaluator.py DetectionMAP:298 over the detection_map op's
    state slots): ``get_map_var()`` gives (this batch's mAP, the mAP over
    every batch since the last ``reset``)."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super(DetectionMAP, self).__init__("map_eval")
        gt_label = fluid_layers.cast(x=gt_label, dtype=gt_box.dtype)
        # the dense layout is [B, M, slots], slots (label, box, difficult)
        # in the detection_map host op's order
        if gt_difficult is not None:
            gt_difficult = fluid_layers.cast(x=gt_difficult,
                                             dtype=gt_box.dtype)
            label = fluid_layers.concat([gt_label, gt_box, gt_difficult],
                                        axis=-1)
        else:
            label = fluid_layers.concat([gt_label, gt_box], axis=-1)
        self.cur_map = fluid_layers.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)
        # accumulation state: per-class (class, n_gt) rows and scored tp /
        # fp rows
        self._create_state("accum_pos_count", "float32", [0, 2])
        self._create_state("accum_true_pos", "float32", [0, 2])
        self._create_state("accum_false_pos", "float32", [0, 2])
        self.has_state = self.helper.create_global_variable(
            name="_".join([self.helper.name, "has_state"]),
            persistable=True, dtype="int32", shape=[1])
        self.helper.set_variable_initializer(self.has_state, Constant(0))
        self.accum_map = fluid_layers.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult,
            has_state=self.has_state, input_states=self.states,
            out_states=self.states, ap_version=ap_version)
        fluid_layers.fill_constant(shape=[1], value=1, dtype="int32",
                                   out=self.has_state)
        self.metrics = [self.cur_map, self.accum_map]

    def get_map_var(self):
        """(this batch's mAP var, the accumulated mAP var)."""
        return self.cur_map, self.accum_map

    def reset(self, executor, reset_program=None):
        super(DetectionMAP, self).reset(executor, reset_program)
        scope = global_scope()
        old = scope.get(self.has_state.name)
        device = old.device if old is not None else executor.device
        scope.set(self.has_state.name,
                  torch.zeros([1], dtype=torch.int32, device=device))
