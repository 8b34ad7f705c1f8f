from koifish_tpu_torch.ops.matmul import qmatmul, linear  # noqa: F401
from koifish_tpu_torch.ops.norms import rmsnorm, layernorm  # noqa: F401
from koifish_tpu_torch.ops.rope import rope_freqs, apply_rope  # noqa: F401
from koifish_tpu_torch.ops.attention import (  # noqa: F401
    causal_attention, decode_attention)
from koifish_tpu_torch.ops.cross_entropy import cross_entropy_loss  # noqa: F401
from koifish_tpu_torch.ops.sampling import sample_logits  # noqa: F401
