"""Learning-rate schedules (the port's counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``): each builds its
rate as ops of the main program over the global step counter
``@LR_DECAY_COUNTER@`` (an int64 [1] that an increment op at the head of
the program advances every run), so the rate is a float32 [1] computed on
the device each step, with no read back to the host."""
import math

from . import nn
from . import tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
           "linear_lr_warmup", "append_LARS"]

LR_COUNTER = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    counter = nn.autoincreased_step_counter(counter_name=LR_COUNTER,
                                            begin=begin, step=1)
    return tensor.cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, step * warmup_steps^-1.5), the step
    counted from 1."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div = global_step / float(decay_steps)
    if staircase:
        from .ops import floor
        div = floor(div)
    return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div = global_step / float(decay_steps)
    if staircase:
        from .ops import floor
        div = floor(div)
    from .ops import exp
    return learning_rate * exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div = global_step / float(decay_steps)
    if staircase:
        from .ops import floor
        div = floor(div)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        from .ops import ceil
        div_res = ceil(global_step / float(decay_steps))
        # step 0 gives a zero div_res, as in the JAX package
        decay_steps_var = div_res * float(decay_steps)
        frac = global_step / decay_steps_var
    else:
        frac = nn.elementwise_min(
            global_step / float(decay_steps),
            tensor.fill_constant((1,), "float32", 1.0))
    return (learning_rate - end_learning_rate) * \
        ((1.0 - frac) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i] (the last value past
    them all), as a select over compare masks rather than a Switch
    sub-program."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must equal len(boundaries) + 1")
    global_step = _decay_step_counter()
    lr = tensor.fill_constant((1,), "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        boundary = tensor.fill_constant((1,), "float32", float(b))
        cond = tensor.cast(nn.logical_not(
            _greater_equal(global_step, boundary)), "float32")
        lr = cond * float(v) + (1.0 - cond) * lr
    return lr


def _greater_equal(x, y):
    from .control_flow import greater_equal
    return greater_equal(x, y)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    from .ops import cos, floor
    cur_epoch = floor(global_step / float(step_each_epoch))
    return learning_rate * 0.5 * (
        cos(cur_epoch * float(math.pi) / float(epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr to end_lr linearly over warmup_steps, then learning_rate (a
    float or a schedule's Variable)."""
    global_step = _decay_step_counter()
    frac = nn.elementwise_min(
        global_step / float(warmup_steps),
        tensor.fill_constant((1,), "float32", 1.0))
    warm = start_lr + (end_lr - start_lr) * frac
    if isinstance(learning_rate, (float, int)):
        learning_rate = tensor.fill_constant((1,), "float32",
                                             float(learning_rate))
    is_warm = tensor.cast(nn.logical_not(_greater_equal(
        global_step, tensor.fill_constant((1,), "float32",
                                          float(warmup_steps)))), "float32")
    return is_warm * warm + (1.0 - is_warm) * learning_rate


def append_LARS(params_grads, learning_rate, weight_decay):
    """LARS: each parameter's ``optimize_attr['learning_rate']`` becomes the
    Variable lr * ||param|| / (||grad|| + weight_decay * ||param||) (times
    the parameter's own rate where it has one), which the optimizer's
    update op then reads."""
    from .ops import sqrt, square

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    if isinstance(learning_rate, (float, int)):
        learning_rate = tensor.fill_constant((1,), "float32",
                                             float(learning_rate))
    for param, grad in params_grads:
        param_lr = param.optimize_attr.get("learning_rate", 1.0) \
            if param.optimize_attr else 1.0
        param_norm = sqrt(nn.reduce_sum(square(param)))
        grad_norm = sqrt(nn.reduce_sum(square(grad)))
        if isinstance(param_lr, float) and param_lr == 1.0:
            decayed_lr = learning_rate * param_norm / \
                _balanced_weight(param_norm, grad_norm)
        else:
            decayed_lr = learning_rate * param_lr * param_norm / \
                _balanced_weight(param_norm, grad_norm)
        param.optimize_attr["learning_rate"] = decayed_lr
