# Model stack of the serving and training paths: decoder-only or
# encoder-decoder models of dense GQA attention, Mamba-2 SSM or hybrid
# (attention ∥ SSM) blocks with a dense, parallel or MoE FFN (attention,
# ssm, moe, layers, model), the training loss (model), their configuration
# and parameter draws (common).  Loops over one ParameterDict per layer.
from .common import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
    finalize,
)
from .model import (  # noqa: F401
    Model,
    build_cross_cache,
    chunked_xent,
    decode_step,
    encode,
    forward,
    init_cache,
    init_model,
    loss_fn,
    prefill,
)
