"""Model families of the port: Llama (generation, the serving engine's
slot primitives and the LoRA fine-tune), BERT (the GLUE fine-tune), the
image model zoo (``registry``: InceptionV3, Xception, ResNet18–152,
VGG16/19, with the flax weight bridge ``load_flax_variables``) and the
serving-weights cast (``pretrained.cast_float_leaves``), the LLM half of
the registry (``registry.llm_config``, ``draft_for``) and the offline
byte-level BPE tokenizer (``ByteBPETokenizer``)."""

from .bert import (BertConfig, BertEncoder, BertForSequenceClassification,
                   bert_finetune_loss, glue_loss_fn)
from .llama import LlamaConfig, LlamaModel, generate
from .pretrained import cast_float_leaves
from .registry import (SUPPORTED_MODELS, decodePredictions, get_model,
                       load_flax_variables)
from .tokenizer import ByteBPETokenizer

__all__ = ["BertConfig", "BertEncoder", "BertForSequenceClassification",
           "bert_finetune_loss", "glue_loss_fn", "LlamaConfig", "LlamaModel",
           "generate", "cast_float_leaves", "SUPPORTED_MODELS", "get_model",
           "decodePredictions", "load_flax_variables", "ByteBPETokenizer"]
