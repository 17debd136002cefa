"""ParamAttr: per-parameter configuration (the port's counterpart of
``paddle_tpu/fluid/param_attr.py``)."""
from .initializer import Constant, Xavier

__all__ = ["ParamAttr"]


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def _set_default_initializer(self, initializer):
        if initializer is None or self.initializer is not None:
            return
        self.initializer = initializer

    def _set_default_param_initializer(self):
        self._set_default_initializer(Xavier())

    def _set_default_bias_initializer(self):
        self._set_default_initializer(Constant(0.0))

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr._to_attr(None) if arg else False
        if callable(getattr(arg, "__call__", None)):
            return ParamAttr(initializer=arg)
        raise TypeError("invalid param_attr: %r" % (arg,))

    def _to_kwargs(self):
        return {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
