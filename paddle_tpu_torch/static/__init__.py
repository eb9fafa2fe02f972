"""paddle_tpu_torch.static (counterpart of ``paddle_tpu/static``; the port
has ``InputSpec``, which ``hapi.Model`` takes).  The static Program, its
Executor and the rest of the reference's ``static/`` are ROADMAP Queue 1
item 12."""
from .input_spec import InputSpec  # noqa: F401

__all__ = ['InputSpec']
