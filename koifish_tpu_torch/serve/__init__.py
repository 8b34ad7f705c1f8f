from koifish_tpu_torch.serve.engine import generate, prefill  # noqa: F401
from koifish_tpu_torch.serve.kvcache import (  # noqa: F401
    KVCache, cache_for, init_cache)
from koifish_tpu_torch.serve.layered import (  # noqa: F401
    LayeredKVCache, decode_step_layered, init_layered_cache, join_cache,
    split_cache)
