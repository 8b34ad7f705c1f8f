from koifish_tpu_torch.serve.kvcache import (  # noqa: F401
    KVCache, cache_for, init_cache)
from koifish_tpu_torch.serve.engine import (  # noqa: F401
    decode_probs_k, decode_sample, decode_sample_k, decode_sample_layered,
    decode_sample_layered_k, decode_step, generate, prefill, prefill_chunked)
from koifish_tpu_torch.serve.layered import (  # noqa: F401
    LayeredKVCache, decode_step_layered, init_layered_cache, join_cache,
    split_cache)
from koifish_tpu_torch.serve.stacked import (  # noqa: F401
    decode_step_stacked, stack_layers)
from koifish_tpu_torch.serve.speculative import speculative_generate  # noqa: F401
from koifish_tpu_torch.serve.paged import (  # noqa: F401
    PagedKVCache, generate_paged, init_paged_cache)
from koifish_tpu_torch.serve.batching import (  # noqa: F401
    ContinuousBatcher, Request)
