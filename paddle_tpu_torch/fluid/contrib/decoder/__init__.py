from .beam_search_decoder import (InitState, StateCell, TrainingDecoder,
                                  BeamSearchDecoder)

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]
