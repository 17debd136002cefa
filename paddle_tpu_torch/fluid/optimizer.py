"""Optimizers: build per-parameter update ops into the program.

The port's counterpart of ``paddle_tpu/fluid/optimizer.py``: the same
``minimize`` (append_backward, clip, regularization, one update op per
parameter), the same global learning-rate var and the same accumulator
names made through the startup program, so a Program built here equals the
JAX package's and ``params_from_numpy`` can carry moments and beta powers
across. Every optimizer of the JAX package is here, under its long and its
short name, with ModelAverage.
"""
from collections import defaultdict

import torch

from .framework import (Variable, default_main_program,
                        default_startup_program, program_guard)
from .core_types import OpRole
from .backward import append_backward
from . import unique_name
from .clip import append_gradient_clip_ops, error_clip_callback
from .regularizer import append_regularization_ops
from . import sparse_grads

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad", "Ftrl",
    "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "DecayedAdagradOptimizer", "RMSPropOptimizer",
    "FtrlOptimizer", "Adadelta", "AdadeltaOptimizer", "ModelAverage",
    "LarsMomentum", "LarsMomentumOptimizer", "RMSProp",
]


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


class LarsMomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super(LarsMomentumOptimizer, self).__init__(learning_rate,
                                                    regularization, name)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = float(lars_coeff)
        self._lars_weight_decay = float(lars_weight_decay)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator(self._velocity_acc_str, p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super(AdagradOptimizer, self).__init__(learning_rate, regularization,
                                               name)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p,
                                  fill_value=self._initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator(self._moment_acc_str, p)
        inputs = {"Param": [p.name], "Moment": [m.name],
                  "LearningRate": [self._create_param_lr(param_and_grad).name]}
        inputs.update(self._grad_inputs(block, g))
        return block.append_op(
            type="adagrad", inputs=inputs,
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super(AdamaxOptimizer, self).__init__(learning_rate, regularization,
                                              name)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator(self._moment_acc_str, p)
        inf = self._get_accumulator(self._inf_norm_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [inf.name], "Beta1Pow": [b1p.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        """Advance each Beta1Pow by beta1, one scale op a parameter after
        the update ops."""
        for p, g in parameters_and_grads:
            if g is None:
                continue
            b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
            block.append_op(type="scale", inputs={"X": [b1p.name]},
                            outputs={"Out": [b1p.name]},
                            attrs={"scale": self._beta1,
                                   OpRole.KEY: OpRole.Optimize})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      regularization, name)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator(self._moment_acc_str, p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super(AdadeltaOptimizer, self).__init__(learning_rate, regularization,
                                                name)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, p)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "AvgSquaredGrad": [asg.name],
                    "AvgSquaredUpdate": [asu.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [asg.name],
                     "AvgSquaredUpdateOut": [asu.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super(RMSPropOptimizer, self).__init__(learning_rate, regularization,
                                               name)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator(self._momentum_acc_str, p)
        ms = self._get_accumulator(self._mean_square_acc_str, p)
        mg = self._get_accumulator(self._mean_grad_acc_str, p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [mom.name],
                    "MeanSquare": [ms.name], "MeanGrad": [mg.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [mom.name],
                     "MeanSquareOut": [ms.name], "MeanGradOut": [mg.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super(FtrlOptimizer, self).__init__(learning_rate, regularization,
                                            name)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator(self._squared_acc_str, p)
        lin = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name],
                    "LearningRate": [
                        self._create_param_lr(param_and_grad).name]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """Parameter averages over a sliding window: ``build`` appends one
    average_accumulates op a trainable parameter, ``apply`` puts the
    averages in the parameters' place in the global scope and ``restore``
    puts the very tensors it took back."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super(ModelAverage, self).__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._avg_infos = []
        self._restore_vals = {}

    def _append_average_accumulate_op(self, param):
        block = default_main_program().global_block()
        sum_1 = self._add_accumulator("sum_1", param, dtype="float32")
        sum_2 = self._add_accumulator("sum_2", param, dtype="float32")
        sum_3 = self._add_accumulator("sum_3", param, dtype="float32")
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int64", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int64", shape=[1])
        num_upd = self._add_accumulator("num_updates", param, dtype="int64",
                                        shape=[1])
        self._avg_infos.append((param, sum_1, sum_2, sum_3, num_acc, old_num,
                                num_upd))
        block.append_op(
            type="average_accumulates",
            inputs={"param": [param.name], "in_sum_1": [sum_1.name],
                    "in_sum_2": [sum_2.name], "in_sum_3": [sum_3.name],
                    "in_num_accumulates": [num_acc.name],
                    "in_old_num_accumulates": [old_num.name],
                    "in_num_updates": [num_upd.name]},
            outputs={"out_sum_1": [sum_1.name], "out_sum_2": [sum_2.name],
                     "out_sum_3": [sum_3.name],
                     "out_num_accumulates": [num_acc.name],
                     "out_old_num_accumulates": [old_num.name],
                     "out_num_updates": [num_upd.name]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window,
                   OpRole.KEY: OpRole.Optimize})

    def build(self, params=None):
        params = params or default_main_program().all_parameters()
        for p in params:
            if p.trainable:
                self._append_average_accumulate_op(p)

    def apply(self, executor=None, need_restore=True):
        """Each parameter with a count becomes (sum_1 + sum_2 + sum_3) /
        (num_accumulates + old_num_accumulates), summed and divided in
        float64 on the tensors' device (one host read for all the counts)
        and rounded to the parameter's dtype."""
        from .executor import global_scope
        scope = global_scope()
        self._restore_vals = {}
        if not self._avg_infos:
            return
        counts = torch.stack([
            (scope.get(na.name) + scope.get(on.name)).reshape(())
            for _, _, _, _, na, on, _ in self._avg_infos]).cpu().tolist()
        for (p, s1, s2, s3, _, _, _), cnt in zip(self._avg_infos, counts):
            if cnt <= 0:
                continue
            total = scope.get(s1.name).double() + \
                scope.get(s2.name).double() + scope.get(s3.name).double()
            value = scope.get(p.name)
            self._restore_vals[p.name] = value
            scope.set(p.name, (total / float(cnt)).to(value.dtype))

    def restore(self, executor=None):
        from .executor import global_scope
        scope = global_scope()
        for name, val in self._restore_vals.items():
            scope.set(name, val)
        self._restore_vals = {}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
