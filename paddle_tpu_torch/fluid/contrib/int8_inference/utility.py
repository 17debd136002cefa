"""Post-training int8 calibration (the port's counterpart of
``paddle_tpu/fluid/contrib/int8_inference/utility.py``; reference:
python/paddle/fluid/contrib/int8_inference/utility.py): collect activation
ranges over sample batches, then emit an int8 inference model.

As in the JAX package, the calibrated model keeps float ops: it records a
per-tensor scale for each sampled activation in the program's
``_dist_attrs["int8_scales"]`` and stores the weights as int8
(``QuantizeTranspiler.convert_to_int8``), dequantized as the model loads.
``sample_data`` fetches the first 256 float op outputs, in op order, and
brings them to the host; ``algo`` is kept and not read (the JAX package
takes the running max |x| whatever it says: ROADMAP Queue 3)."""
import numpy as np

__all__ = ["Calibrator"]


class Calibrator(object):
    def __init__(self, program=None, pretrained_model=None, iterations=-1,
                 debug=False, algo="KL", exe=None, feed_var_names=None,
                 fetch_list=None, scope=None):
        self.program = program
        self.iterations = iterations
        self.debug = debug
        self.algo = algo
        self.exe = exe
        self.feed_var_names = feed_var_names
        self.fetch_list = fetch_list
        self.scope = scope
        self._ranges = {}      # var name -> running max |activation|

    def sampled_names(self):
        """The float op outputs sample_data fetches: the first 256, in op
        order, each once."""
        block = self.program.global_block()
        fetch = []
        for op in block.ops:
            for name in op.output_arg_names:
                v = block.vars.get(name)
                if v is not None and str(v.dtype).startswith("float"):
                    fetch.append(name)
        return list(dict.fromkeys(fetch))[:256]

    def sample_data(self, feed=None):
        """Run one batch and take each sampled output's running max |x|
        (reference: Calibrator.sample_data)."""
        from ... import executor as _executor
        scope = self.scope or _executor.global_scope()
        fetch = self.sampled_names()
        outs = self.exe.run(self.program, feed=feed, fetch_list=fetch,
                            scope=scope)
        for name, val in zip(fetch, outs):
            mx = float(np.max(np.abs(np.asarray(val, dtype=np.float32))))
            self._ranges[name] = max(self._ranges.get(name, 0.0), mx)

    def save_int8_model(self, dirname=None, feeded_var_names=None,
                        target_vars=None):
        """Record the scales, convert the weights to int8 and, given a
        directory, save the inference model there (reference: writes the
        __model__ with quantize / dequantize ops). Returns the program."""
        from ... import io as fluid_io
        from .quant_scope import noop  # noqa: F401  (the module layout)
        for name, mx in self._ranges.items():
            self.program._dist_attrs.setdefault("int8_scales", {})[name] = \
                (mx / 127.0) if mx else 1.0
        from ..quantize import QuantizeTranspiler
        QuantizeTranspiler().convert_to_int8(self.program, scope=self.scope)
        if dirname:
            fluid_io.save_inference_model(
                dirname, feeded_var_names or self.feed_var_names,
                target_vars or self.fetch_list, self.exe,
                main_program=self.program)
        return self.program
