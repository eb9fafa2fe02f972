"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): each
calls its functional with the layer's settings; ``HSigmoidLoss`` owns
the tree's node weights and biases."""
from .. import functional as F
from .layers import Layer

__all__ = ['CrossEntropyLoss', 'BCELoss', 'BCEWithLogitsLoss', 'MSELoss',
           'L1Loss', 'NLLLoss', 'KLDivLoss', 'SmoothL1Loss',
           'MarginRankingLoss', 'CTCLoss', 'HingeEmbeddingLoss',
           'CosineEmbeddingLoss', 'SigmoidFocalLoss', 'HSigmoidLoss']


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MSELoss(Layer):
    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction='mean', delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction='mean'):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction='mean', name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class SigmoidFocalLoss(Layer):
    def __init__(self, alpha=0.25, gamma=2.0, reduction='sum', name=None):
        super().__init__()
        self.alpha = alpha
        self.gamma = gamma
        self.reduction = reduction

    def forward(self, logit, label, normalizer=None):
        return F.sigmoid_focal_loss(logit, label, normalizer, self.alpha,
                                    self.gamma, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over ``num_classes``: ``num_classes - 1``
    node rows of ``feature_size`` weights (``num_classes`` with a
    custom tree, whose tables then come with every call)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.is_custom = is_custom
        n_nodes = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter(
            [max(n_nodes, 1), feature_size], attr=weight_attr)
        self.bias = self.create_parameter(
            [max(n_nodes, 1)], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise ValueError('HSigmoidLoss(is_custom=True) needs '
                             'path_table and path_code')
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)
