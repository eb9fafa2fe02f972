"""Hot ops of the port: hand-written Hopper kernels with their plain
PyTorch twins, and the plain PyTorch counterparts of the reference's
jnp hot ops.  Importing the package registers the forward kernels as
the ``paddle_tpu_torch::*`` operators (``_library``), which a loaded
``jit.save`` artifact calls."""
from . import _library  # noqa: F401  (registers the operators first)
from .fused_norm import fused_layer_norm
from .fused_softmax import fused_softmax

__all__ = ['fused_layer_norm', 'fused_softmax']
