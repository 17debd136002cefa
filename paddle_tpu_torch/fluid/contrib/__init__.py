"""fluid.contrib (reference: python/paddle/fluid/contrib/): the seq2seq
decoder API, ``InitState``, ``StateCell``, ``TrainingDecoder`` and
``BeamSearchDecoder``. The rest of the JAX package's ``contrib`` (Trainer
and Inferencer, quantization, slim, the int8 calibrator, the float16
transpiler, the HDFS utilities, the reader and the extras) waits for
ROADMAP Queue 1 item 11: those names are absent here."""
from . import decoder
from .decoder import InitState, StateCell, TrainingDecoder, BeamSearchDecoder

__all__ = ["decoder", "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
