"""Serving runtime of the port: the padded and continuous engine and the
greedy sampler."""
from repro_torch.serving.engine import (BatchResult, EngineConfig,  # noqa: F401
                                        InferenceEngine)
from repro_torch.serving.sampling import greedy  # noqa: F401
