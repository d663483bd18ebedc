# Model stack of the serving path: decoders of dense GQA attention, Mamba-2
# SSM or hybrid (attention ∥ SSM) blocks (attention, ssm, layers, model),
# their configuration and parameter builder (common).  Loops over one
# ParameterDict per layer; MoE and encoder-decoder blocks are not ported
# yet and raise.
from .common import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
    finalize,
)
from .model import (  # noqa: F401
    Model,
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)
