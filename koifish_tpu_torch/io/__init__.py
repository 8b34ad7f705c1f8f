from koifish_tpu_torch.io.safetensors import (  # noqa: F401
    read_safetensors, write_safetensors, iter_hf_folder, read_header,
)
from koifish_tpu_torch.io.checkpoint import (  # noqa: F401
    save_train_state, load_train_state, save_model, load_model, load_model_card,
)
from koifish_tpu_torch.io.hf_loader import load_hf_model  # noqa: F401
