from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_reference  # noqa: F401
from repro_torch.kernels.decode_attention.partial import (  # noqa: F401
    combine_partials, decode_attention_partial)
