from koifish_tpu_torch.train.optimizer import (OptState, apply_updates,  # noqa: F401
                                               init_opt_state)
from koifish_tpu_torch.train.schedule import lr_at  # noqa: F401
from koifish_tpu_torch.train.trainer import (StepInfo, TrainingInstability,  # noqa: F401
                                             TrainState, compute_loss,
                                             init_train_state, make_train_step,
                                             train_loop)
