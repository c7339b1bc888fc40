from .beam_search_decoder import (InitState, StateCell, TrainingDecoder,
                                  BeamSearchDecoder)
