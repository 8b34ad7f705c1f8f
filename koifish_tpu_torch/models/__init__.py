from koifish_tpu_torch.models.transformer import (  # noqa: F401
    gather_embed, init_params, layer_forward, lm_head, model_forward)
# the model zoo's modules (the JAX package's models/<name>.py each)
from koifish_tpu_torch.models import (  # noqa: F401
    backbone, brown, embed_vae, gau, guppy, hotpick, mamba, mla, moe, salmon)
