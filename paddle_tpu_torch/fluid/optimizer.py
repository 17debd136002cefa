"""Optimizers: build per-parameter update ops into the program.

The port's counterpart of ``paddle_tpu/fluid/optimizer.py``: the same
``minimize`` (append_backward, clip, regularization, one update op per
parameter), the same global learning-rate var and the same accumulator
names made through the startup program, so a Program built here equals the
JAX package's and ``params_from_numpy`` can carry moments and beta powers
across. SGD and Adam are ported; the others come with the models that use
them.
"""
from collections import defaultdict

from .framework import (Variable, default_main_program,
                        default_startup_program, program_guard)
from .core_types import OpRole
from .backward import append_backward
from . import unique_name
from .clip import append_gradient_clip_ops, error_clip_callback
from .regularizer import append_regularization_ops
from . import sparse_grads

__all__ = ["SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer"]


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        name = unique_name.generate("learning_rate")
        lr_var = program.global_block().create_var(
            name=name, shape=(1,), dtype="float32", persistable=True)
        self._learning_rate_map[program] = lr_var
        sb = default_startup_program().global_block()
        sb.create_var(name=name, shape=(1,), dtype="float32", persistable=True)
        sb.append_op(type="fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1], "value": float(self._learning_rate),
                            "dtype": "float32", OpRole.KEY: OpRole.LRSched})

    @property
    def global_learning_rate(self):
        return self._learning_rate_map.get(default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        lr_var = self._learning_rate_map[default_main_program()]
        mult = param.optimize_attr.get("learning_rate", 1.0) if \
            param.optimize_attr else 1.0
        if isinstance(mult, Variable):
            return mult
        if mult == 1.0:
            return lr_var
        block = default_main_program().global_block()
        out = block.create_var(name=unique_name.generate(param.name + "_lr"),
                               shape=(1,), dtype="float32")
        block.append_op(type="scale", inputs={"X": [lr_var.name]},
                        outputs={"Out": [out.name]},
                        attrs={"scale": mult, OpRole.KEY: OpRole.Optimize})
        return out

    # -- accumulators ------------------------------------------------------
    def get_opti_var_name_list(self):
        """Names of every optimizer accumulator."""
        names = []
        for per_param in self._accumulators.values():
            names.extend(v.name for v in per_param.values())
        return names

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate("%s_%s_%s" % (param.name, name, "acc"))
        var = default_main_program().global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        sb = default_startup_program().global_block()
        sb.create_var(name=var_name, shape=shape, dtype=dtype, persistable=True)
        sb.append_op(type="fill_constant", outputs={"Out": [var_name]},
                     attrs={"shape": shape, "value": float(fill_value),
                            "dtype": dtype})
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- main entry points -------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, parameters_and_grads):
        program = default_main_program()
        block = program.global_block()
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if sparse_grads.sparse_rows_var(
                    block, param_and_grad[1].name) is not None and \
                    self.type not in sparse_grads.SPARSE_CAPABLE_OPTIMIZERS:
                # no sparse update for this optimizer: densify the pair
                param_and_grad = (param_and_grad[0], sparse_grads.densify(
                    block, param_and_grad[0], param_and_grad[1]))
            op = self._append_optimize_op(block, param_and_grad)
            op.attrs[OpRole.KEY] = OpRole.Optimize
            op.attrs[OpRole.VAR_KEY] = [param_and_grad[0].name,
                                        param_and_grad[1].name]
            optimize_ops.append(op)
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        startup = startup_program or default_startup_program()
        with program_guard(loss.block.program, startup):
            params_grads = self.backward(loss, startup_program, parameter_list,
                                         no_grad_set, [error_clip_callback])
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError()

    @staticmethod
    def _grad_inputs(block, grad):
        """The update op's grad slots: Grad, and GradRows when the grad is
        a sparse (values, rows) pair."""
        inputs = {"Grad": [grad.name]}
        rows = sparse_grads.sparse_rows_var(block, grad.name)
        if rows is not None:
            inputs["GradRows"] = [rows]
        return inputs


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super(SGDOptimizer, self).__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {"Param": [p.name],
                  "LearningRate": [self._create_param_lr(param_and_grad).name]}
        inputs.update(self._grad_inputs(block, g))
        return block.append_op(type="sgd", inputs=inputs,
                               outputs={"ParamOut": [p.name]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super(MomentumOptimizer, self).__init__(learning_rate, regularization,
                                                name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            # f32 velocity whatever the param dtype
            self._add_accumulator(self._velocity_acc_str, p,
                                  dtype="float32")

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator(self._velocity_acc_str, p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None, lazy_mode=False):
        super(AdamOptimizer, self).__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            # f32 moments whatever the param dtype
            self._add_accumulator(self._moment1_acc_str, p, dtype="float32")
            self._add_accumulator(self._moment2_acc_str, p, dtype="float32")
            self._add_accumulator(self._beta1_pow_acc_str, p, dtype="float32",
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p, dtype="float32",
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
        inputs = {"Param": [p.name],
                  "Moment1": [m1.name], "Moment2": [m2.name],
                  "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                  "LearningRate": [self._create_param_lr(param_and_grad).name]}
        inputs.update(self._grad_inputs(block, g))
        return block.append_op(
            type="adam", inputs=inputs,
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
