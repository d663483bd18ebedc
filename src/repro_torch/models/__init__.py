# Model stack of the serving path: dense GQA decoders (attention, layers,
# model), their configuration and parameter builder (common).  Loops over
# one ParameterDict per layer; SSM, MoE and encoder-decoder blocks are not
# ported yet and raise.
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
