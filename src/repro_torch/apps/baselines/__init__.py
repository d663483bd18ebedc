# Hand-coded "native" implementations (the paper's LonestarGPU ports and
# native OpenCL bitonic sort, re-expressed as dense PyTorch): what TREES'
# generality is benchmarked against (§6.3, §6.4).  Plain torch functions
# that take a ``device`` (CUDA unless the caller asks for another), not
# kernels.
from . import bitonic, worklist  # noqa: F401
