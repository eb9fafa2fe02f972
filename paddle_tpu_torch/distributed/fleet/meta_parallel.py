"""Tensor-parallel layers, single-device behaviour.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel.py``
(``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``).  There the layers hold full logical
parameters and a PartitionSpec each; on one device they are plain
layers, which is all this slice ports.  Sharding over
``torch.distributed`` comes with the distributed slice.
"""
from ...nn.initializer import XavierNormal
from ...nn.layer.common import Embedding, Linear

__all__ = ['ColumnParallelLinear', 'RowParallelLinear',
           'VocabParallelEmbedding']


class ColumnParallelLinear(Linear):
    """``Y = XW + b``; W would be column-split over tensor parallel."""

    def __init__(self, in_features, out_features, gather_output=True,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """``Y = XW + b``; W would be row-split over tensor parallel."""

    def __init__(self, in_features, out_features, input_is_parallel=False,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocab axis would be split over tensor parallel;
    its default init is XavierNormal, as the reference's (``nn.Embedding``
    draws N(0, 1))."""

    def reset_parameters(self, generator):
        XavierNormal().fill_(self.weight, generator)
