"""Model families of the port: Llama (generation, the serving engine's
slot primitives and the LoRA fine-tune) and BERT (the GLUE fine-tune),
and the serving-weights cast (``pretrained.cast_float_leaves``)."""

from .bert import (BertConfig, BertEncoder, BertForSequenceClassification,
                   bert_finetune_loss, glue_loss_fn)
from .llama import LlamaConfig, LlamaModel, generate
from .pretrained import cast_float_leaves

__all__ = ["BertConfig", "BertEncoder", "BertForSequenceClassification",
           "bert_finetune_loss", "glue_loss_fn", "LlamaConfig", "LlamaModel",
           "generate", "cast_float_leaves"]
