from koifish_tpu_torch.quant.apply import param_path, quantize_params  # noqa: F401
from koifish_tpu_torch.quant.qtensor import (  # noqa: F401
    NF3_CODEBOOK, NF4_CODEBOOK, QTensor, codebook_for)
from koifish_tpu_torch.quant.rtn import (  # noqa: F401
    fake_quant, quant_error, quantize, quantize_best)
from koifish_tpu_torch.quant.packing import pack_codes, unpack_codes  # noqa: F401
