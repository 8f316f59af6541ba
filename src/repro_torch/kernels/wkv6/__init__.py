from repro_torch.kernels.wkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.wkv6.ref import (  # noqa: F401
    wkv6_chunked, wkv6_sequential, wkv6_step)
