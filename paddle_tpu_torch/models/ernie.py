"""The ERNIE family (counterpart of ``paddle_tpu/models/ernie.py``).

ERNIE 1.0 shares BERT's encoder; what differs is its pretraining data
(phrase- and entity-level masking, the caller's labelling) and its
configuration: vocab 18000, type vocab 4.  So, as in the reference,
these are the port's BERT classes (``models/bert.py``) with ERNIE's
dimensions, the same state-dict keys and kernels.
"""
from .bert import BertConfig, BertForPretraining, BertModel

__all__ = ['ErnieConfig', 'ErnieModel', 'ErnieForPretraining',
           'ernie_base', 'ernie_tiny']


class ErnieConfig(BertConfig):
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=513, type_vocab_size=4,
                 **kw):
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_layers=num_layers, num_heads=num_heads,
                         max_seq_len=max_seq_len,
                         type_vocab_size=type_vocab_size, **kw)


class ErnieModel(BertModel):
    """ERNIE 1.0 encoder (BERT's, at ERNIE's dimensions)."""


class ErnieForPretraining(BertForPretraining):
    """MLM + next-sentence heads over the ERNIE encoder; phrase/entity
    masking is the caller's labelling."""


def ernie_base(device=None, seed=0, **kw):
    """ERNIE 1.0 base: vocab 18000, hidden 768, 12 layers, 12 heads,
    type vocab 4, 513 positions."""
    return ErnieForPretraining(ErnieConfig(**kw), device=device, seed=seed)


def ernie_tiny(device=None, seed=0, **kw):
    """2-layer toy config for tests."""
    kw.setdefault('vocab_size', 128)
    kw.setdefault('hidden_size', 32)
    kw.setdefault('num_layers', 2)
    kw.setdefault('num_heads', 2)
    kw.setdefault('max_seq_len', 64)
    return ErnieForPretraining(ErnieConfig(**kw), device=device, seed=seed)
