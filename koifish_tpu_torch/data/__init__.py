from koifish_tpu_torch.data.tokenizer import BPETokenizer, ScoreTokenizer  # noqa: F401
from koifish_tpu_torch.data.tokenset import (  # noqa: F401
    TokenDataset, read_shard, write_shard, read_hellaswag_shard,
    MAGIC_GPT2, MAGIC_QWEN25, MAGIC_QWEN3, MAGIC_HELLASWAG,
)
from koifish_tpu_torch.data.chat_template import (  # noqa: F401
    render, render_chatml, sft_sample_to_tokens,
)
