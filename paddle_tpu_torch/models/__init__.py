from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large, bert_tiny)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    ernie_base, ernie_tiny)
from .gpt import (GPTConfig, GPT, GPTForCausalLM, gpt_1p3b, gpt_moe_tiny,
                  gpt_small, gpt_tiny)
from .widedeep import DeepFM, WideDeep

__all__ = ['GPTConfig', 'GPT', 'GPTForCausalLM', 'gpt_tiny', 'gpt_small',
           'gpt_1p3b', 'gpt_moe_tiny',
           'WideDeep', 'DeepFM', 'BertConfig', 'BertModel',
           'BertForPretraining', 'bert_tiny', 'bert_base', 'bert_large',
           'ErnieConfig', 'ErnieModel', 'ErnieForPretraining', 'ernie_base',
           'ernie_tiny']
