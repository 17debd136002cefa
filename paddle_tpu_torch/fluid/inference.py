"""Inference deployment API.

Reference parity: paddle/fluid/inference/api/paddle_api.h:199 PaddlePredictor
+ AnalysisPredictor (analysis_predictor.h:46).

The port's counterpart of ``paddle_tpu/fluid/inference.py``: the predictor
loads a saved inference model (io.load_inference_model) into a private
Scope and runs the loaded program, feed and fetch ops included, through the
port's Executor. The executor plans per program, not per input shape, so a
new batch size runs without a rebuild.

One departure: ``use_gpu`` defaults to True and means ``CUDAPlace(device)``
(in the JAX package it defaults to False and does nothing); a predictor
runs on the CPU only when the config sets ``use_gpu = False``.
"""
from . import io as fluid_io
from .executor import Executor, Scope, scope_guard
from .framework import CPUPlace, CUDAPlace

__all__ = ["NativeConfig", "AnalysisConfig", "PaddlePredictor",
           "create_paddle_predictor", "Predictor"]


class NativeConfig(object):
    def __init__(self):
        self.model_dir = ""
        self.prog_file = None
        self.param_file = None
        self.use_gpu = True
        self.device = 0


class AnalysisConfig(NativeConfig):
    def __init__(self, model_dir=""):
        super(AnalysisConfig, self).__init__()
        self.model_dir = model_dir
        self._ir_optim = True

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag  # kept for the reference's scripts

    def enable_tensorrt_engine(self, *a, **k):
        pass  # no TensorRT in the port: the program runs as it is


class PaddlePredictor(object):
    """Loads a saved inference model and serves it through the Executor on
    ``CUDAPlace(config.device)``, or on the CPU when ``use_gpu`` is False."""

    def __init__(self, config):
        self.config = config
        place = CUDAPlace(config.device) if config.use_gpu else CPUPlace()
        self.scope = Scope()
        self.exe = Executor(place)
        with scope_guard(self.scope):
            prog, feeds, fetches = fluid_io.load_inference_model(
                config.model_dir, self.exe,
                model_filename=config.prog_file,
                params_filename=config.param_file)
        self.program = prog
        self.feed_names = feeds
        self.fetch_vars = fetches

    def run(self, inputs, return_numpy=True):
        """inputs: dict name -> array or list ordered like feed_names.
        Returns the fetch ops' values, in their ``col`` order."""
        if not isinstance(inputs, dict):
            inputs = dict(zip(self.feed_names, inputs))
        feed = {n: inputs[n] for n in self.feed_names}
        return self.exe.run(self.program, feed=feed, scope=self.scope,
                            return_numpy=return_numpy)

    def export_stablehlo(self, example_inputs):
        raise NotImplementedError(
            "export_stablehlo is not ported: the port has no StableHLO "
            "artifact (ROADMAP Queue 1 item 11: serving and contrib)")


Predictor = PaddlePredictor


def create_paddle_predictor(config):
    return PaddlePredictor(config)
