"""What the port's vision models share: the random init from an
explicit CPU generator and loading the JAX model's weights."""
import torch
from torch import nn


class SeededModel(nn.Module):
    """A model whose parameters are drawn, in module order, by each
    layer's ``reset_parameters(generator)`` from a CPU generator seeded
    with ``seed``, so one seed gives the same weights on every device."""

    def init_weights(self, seed):
        generator = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if m is not self and hasattr(m, 'reset_parameters'):
                m.reset_parameters(generator)

    def load_numpy_state(self, params, buffers=None):
        """Load the JAX model's ``functional_state()`` (params and
        buffers, as numpy); raises on a missing or extra key or a
        shape/dtype mismatch."""
        from ...convert import load_numpy_state
        load_numpy_state(self, params, buffers)
        return self
