from koifish_tpu_torch.data.tokenizer import BPETokenizer  # noqa: F401
from koifish_tpu_torch.data.chat_template import (  # noqa: F401
    render, render_chatml, sft_sample_to_tokens,
)
