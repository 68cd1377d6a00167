"""The train step (the port of ``repro.train``)."""
from repro_torch.train.step import TrainConfig, abstract_state, \
    init_state, make_train_step  # noqa: F401
