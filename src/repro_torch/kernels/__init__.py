# Hand-written Hopper kernels for the framework's compute hot-spots:
#   build.py            nvcc build of csrc/ into build/ (one library a source)
#   flash_attention.py  ctypes binding + launch of the flash-attention kernel
#   rglru_scan.py       ctypes binding + launch of the RG-LRU scan kernel
#   csrc/               the kernels' CUDA C++ sources
#   ops.py              autograd wrappers (kernel on CUDA, plain ref on CPU)
#   ref.py              plain PyTorch versions (correctness ground truth)
from . import ref
from .ops import flash_attention, rglru_scan

__all__ = ["flash_attention", "rglru_scan", "ref"]
