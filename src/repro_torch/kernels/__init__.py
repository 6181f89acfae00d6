# Hand-written Hopper kernels for the framework's compute hot-spots:
#   flash_attention.py  build + ctypes binding + launch of the CUDA kernel
#   csrc/               the kernels' CUDA C++ sources
#   ops.py              autograd wrappers (kernel on CUDA, plain ref on CPU)
#   ref.py              plain PyTorch versions (correctness ground truth)
from . import ref
from .ops import flash_attention

__all__ = ["flash_attention", "ref"]
