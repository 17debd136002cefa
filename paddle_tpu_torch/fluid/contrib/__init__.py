"""fluid.contrib (reference: python/paddle/fluid/contrib/): the seq2seq
decoder API (``InitState``, ``StateCell``, ``TrainingDecoder``,
``BeamSearchDecoder``) and model compression: ``quantize`` with
``QuantizeTranspiler``, the int8 ``Calibrator`` (``int8_inference``) and
``slim`` with its ``Compressor``. The rest of the JAX package's
``contrib`` (Trainer and Inferencer, the float16 transpiler, the HDFS
utilities, the reader and the extras) waits for ROADMAP Queue 1 item 11:
those names are absent here."""
from . import decoder
from .decoder import InitState, StateCell, TrainingDecoder, BeamSearchDecoder
from . import quantize
from .quantize import QuantizeTranspiler
from . import int8_inference
from .int8_inference import Calibrator
from . import slim
from .slim import Compressor

__all__ = ["decoder", "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder", "quantize", "QuantizeTranspiler",
           "Calibrator", "Compressor"]
