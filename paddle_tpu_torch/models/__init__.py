from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large, bert_tiny)
from .gpt import GPTConfig, GPT, GPTForCausalLM, gpt_tiny, gpt_small

__all__ = ['GPTConfig', 'GPT', 'GPTForCausalLM', 'gpt_tiny', 'gpt_small',
           'BertConfig', 'BertModel', 'BertForPretraining', 'bert_tiny',
           'bert_base', 'bert_large']
