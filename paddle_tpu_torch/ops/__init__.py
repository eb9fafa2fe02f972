"""Hot ops of the port: hand-written Hopper kernels with their plain
PyTorch twins, and the plain PyTorch counterparts of the reference's
jnp hot ops.  Importing the package registers the kernels as the
``paddle_tpu_torch::*`` operators (``_library``), which a loaded
``jit.save`` artifact and ``profiler.op_summary``'s fake trace call.

The package exports the reference's four functions
(``paddle_tpu/ops/__init__.py``).  ``ops.flash_attention`` and
``ops.fused_softmax`` are therefore the functions, not the submodules
of the same names: take a submodule with ``importlib.import_module``
(``from .flash_attention import x`` imports it as before)."""
from . import _library  # noqa: F401  (registers the operators first)
from .flash_attention import flash_attention
from .fused_gelu_linear import fused_linear_gelu
from .fused_norm import fused_layer_norm
from .fused_softmax import fused_softmax

__all__ = ['flash_attention', 'fused_layer_norm', 'fused_softmax',
           'fused_linear_gelu']
