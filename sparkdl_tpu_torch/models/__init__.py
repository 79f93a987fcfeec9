"""Model families of the port: Llama (generation, the serving engine's
slot primitives and the LoRA fine-tune), BERT (the GLUE fine-tune), the
image model zoo (``registry``: InceptionV3, Xception, ResNet18–152,
VGG16/19, with the flax weight bridge ``load_flax_variables`` and the
reference's native weight files, ``load_flax_msgpack`` and
``load_safetensors``), the foreign-checkpoint importers and the
serving-weights cast (``pretrained``: ``load_pretrained`` over HF Llama
and BERT safetensors and Keras-applications ``.h5`` files;
``cast_float_leaves``), the LLM half of the registry
(``registry.llm_config``, ``draft_for``) and the offline byte-level BPE
tokenizer (``ByteBPETokenizer``)."""

from .bert import (BertConfig, BertEncoder, BertForSequenceClassification,
                   bert_finetune_loss, glue_loss_fn)
from .llama import LlamaConfig, LlamaModel, generate
from .pretrained import (CheckpointMismatch, cast_float_leaves,
                         import_hf_bert, import_hf_llama,
                         import_keras_inception, import_keras_resnet,
                         import_keras_vgg, import_keras_xception,
                         load_pretrained, merge_into_template, read_keras_h5)
from .registry import (SUPPORTED_MODELS, decodePredictions, get_model,
                       load_flax_msgpack, load_flax_variables,
                       load_safetensors, state_dict_to_flax)
from .tokenizer import ByteBPETokenizer

__all__ = ["BertConfig", "BertEncoder", "BertForSequenceClassification",
           "bert_finetune_loss", "glue_loss_fn", "LlamaConfig", "LlamaModel",
           "generate", "cast_float_leaves", "SUPPORTED_MODELS", "get_model",
           "decodePredictions", "load_flax_variables", "load_flax_msgpack",
           "load_safetensors", "state_dict_to_flax", "ByteBPETokenizer",
           "load_pretrained", "import_hf_llama", "import_hf_bert",
           "import_keras_resnet", "import_keras_vgg",
           "import_keras_inception", "import_keras_xception",
           "read_keras_h5", "merge_into_template", "CheckpointMismatch"]
