from repro_torch.kernels.flash_attention.grad import flash_attention_grad  # noqa: F401
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import flash_attention_reference  # noqa: F401
