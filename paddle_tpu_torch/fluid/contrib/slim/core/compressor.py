"""The model-compression loop (the port's counterpart of
``paddle_tpu/fluid/contrib/slim/core/compressor.py``; reference:
python/paddle/fluid/contrib/slim/core/compress_pass.py and config.py): an
epoch loop that applies compression strategies around a training program.

As in the JAX package, quantization is the strategy the run applies by
itself: when no strategy is configured, or one names quantization, the
training program is transpiled for QAT (``QuantizeTranspiler``) before the
first epoch and the returned program is frozen. Other strategies take
part through their ``on_epoch_begin`` / ``on_batch_end`` /
``on_epoch_end`` hooks (``slim.PruneStrategy``). ``config()`` takes the
reference's YAML file with a ``strategies`` key, a JSON file or a dict."""
import logging

_logger = logging.getLogger(__name__)

__all__ = ["Compressor"]


class Compressor(object):
    def __init__(self, place, scope, train_program, train_reader=None,
                 train_feed_list=None, train_fetch_list=None,
                 eval_program=None, eval_reader=None, eval_feed_list=None,
                 eval_fetch_list=None, teacher_programs=(),
                 checkpoint_path="./checkpoints", train_optimizer=None,
                 distiller_optimizer=None):
        self.place = place
        self.scope = scope
        self.train_program = train_program
        self.train_reader = train_reader
        self.train_feed_list = train_feed_list
        self.train_fetch_list = train_fetch_list
        self.eval_program = eval_program
        self.eval_reader = eval_reader
        self.eval_feed_list = eval_feed_list
        self.eval_fetch_list = eval_fetch_list
        self.teacher_programs = list(teacher_programs)
        self.checkpoint_path = checkpoint_path
        self.train_optimizer = train_optimizer
        self.epoch = 1
        self.strategies = []

    def config(self, config_file):
        """Load the epoch count and strategies from a YAML or JSON file or
        a dict (reference config.py)."""
        if isinstance(config_file, dict):
            cfg = config_file
        else:
            try:
                import yaml
                with open(config_file) as f:
                    cfg = yaml.safe_load(f)
            except ImportError:
                import json
                with open(config_file) as f:
                    cfg = json.load(f)
        comp = cfg.get("compressor", cfg)
        self.epoch = int(comp.get("epoch", self.epoch))
        self.strategies = list(comp.get("strategies", []))
        self._strategy_cfgs = cfg.get("strategies", {})
        return self

    def run(self):
        """Train with the configured strategies applied; returns the final
        (with quantization, frozen) eval program."""
        from ....executor import Executor
        from ...quantize import QuantizeTranspiler

        exe = Executor(self.place)
        hooked = [s for s in self.strategies
                  if hasattr(s, "on_epoch_begin") or
                  hasattr(s, "on_batch_end")]
        quant = any("quant" in str(s) for s in self.strategies) or \
            not self.strategies
        qt = QuantizeTranspiler() if quant else None
        if qt is not None:
            qt.training_transpile(self.train_program)
        for epoch in range(self.epoch):
            ctx = {"epoch": epoch, "program": self.train_program,
                   "scope": self.scope, "exe": exe}
            for s in hooked:
                if hasattr(s, "on_epoch_begin"):
                    s.on_epoch_begin(ctx)
            if self.train_reader is None:
                continue
            for batch in self.train_reader():
                feed = batch if isinstance(batch, dict) else dict(
                    zip(self.train_feed_list, batch))
                exe.run(self.train_program, feed=feed,
                        fetch_list=self.train_fetch_list, scope=self.scope)
                for s in hooked:
                    if hasattr(s, "on_batch_end"):
                        s.on_batch_end(ctx)
            for s in hooked:
                if hasattr(s, "on_epoch_end"):
                    s.on_epoch_end(ctx)
            _logger.info("compressor epoch %d done", epoch)
        final = self.eval_program or self.train_program
        if qt is not None:
            final = final.clone(for_test=True)
            qt.freeze_program(final, self.place, scope=self.scope)
        return final
