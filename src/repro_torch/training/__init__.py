"""Training of the port: optimizers, the train step, gradient compression."""
from repro_torch.training.optimizer import (OptConfig, apply_updates,  # noqa: F401
                                            init_opt_state, opt_state_specs)
from repro_torch.training.trainer import (TrainConfig, init_training,  # noqa: F401
                                          load_train_state, make_train_step,
                                          train_state_tree)
