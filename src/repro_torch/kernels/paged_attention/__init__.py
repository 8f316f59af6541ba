from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_decode_attention, paged_window_attention)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    gather_pool, paged_decode_attention_reference,
    paged_window_attention_reference)
