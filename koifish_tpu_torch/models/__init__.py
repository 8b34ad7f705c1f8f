from koifish_tpu_torch.models.transformer import (  # noqa: F401
    gather_embed, init_params, layer_forward, lm_head, model_forward)
