from koifish_tpu_torch.quant.apply import param_path, quantize_params  # noqa: F401
from koifish_tpu_torch.quant.qtensor import QTensor  # noqa: F401
from koifish_tpu_torch.quant.rtn import quantize  # noqa: F401
