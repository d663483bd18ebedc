# Launch layer: the serving entry point (serve.py), the train step and its
# `build` (train.py) and the sharded fleet's device layout (mesh.py).
from .train import build, init_opt_state, make_train_step  # noqa: F401
