"""L1/L2 weight decay (counterpart of ``paddle_tpu/regularizer.py``).

Passed as an optimizer's ``weight_decay``, an ``L1Decay`` adds
``coeff * sign(p)`` and an ``L2Decay`` ``coeff * p`` to the gradient
before the update (``Optimizer._apply_weight_decay_grad``)."""

__all__ = ['L1Decay', 'L2Decay']


class L1Decay:
    _mode = 'l1'

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L2Decay:
    _mode = 'l2'

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


# legacy 1.x spellings
L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
