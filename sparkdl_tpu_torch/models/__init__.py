"""Model families of the port: Llama (generation, the serving engine's
slot primitives and the LoRA fine-tune), BERT (the GLUE fine-tune), the
image model zoo (``registry``: InceptionV3, Xception, ResNet18–152,
VGG16/19, with the flax weight bridge ``load_flax_variables`` and the
reference's native weight files, ``load_flax_msgpack`` and
``load_safetensors`` / ``save_safetensors``), the foreign-checkpoint
importers and the serving-weights cast (``pretrained``:
``load_pretrained`` over HF Llama and BERT safetensors and
Keras-applications ``.h5`` files; ``cast_float_leaves``), the LLM half
of the registry (``registry.llm_config``, ``draft_for``) and the offline
byte-level BPE tokenizer (``ByteBPETokenizer``)."""

from .bert import (BertConfig, BertEncoder, BertForSequenceClassification,
                   bert_finetune_loss, glue_loss_fn)
from .llama import (LlamaConfig, LlamaModel, causal_lm_loss_fn, generate,
                    lora_mask, lora_optimizer)
from .pretrained import (CheckpointMismatch, cast_float_leaves,
                         import_hf_bert, import_hf_llama,
                         import_keras_inception, import_keras_resnet,
                         import_keras_vgg, import_keras_xception,
                         load_pretrained, merge_into_template, read_keras_h5)
from .registry import (SUPPORTED_MODELS, NamedImageModel,
                       decodePredictions, get_model, load_flax_msgpack,
                       load_flax_variables, load_safetensors, load_weights,
                       preprocess_caffe, preprocess_tf, preprocess_torch,
                       save_safetensors, save_weights, state_dict_to_flax)
from .tokenizer import ByteBPETokenizer

__all__ = ["BertConfig", "BertEncoder", "BertForSequenceClassification",
           "bert_finetune_loss", "glue_loss_fn", "LlamaConfig", "LlamaModel",
           "generate", "causal_lm_loss_fn", "lora_mask", "lora_optimizer",
           "cast_float_leaves", "SUPPORTED_MODELS", "NamedImageModel",
           "get_model", "preprocess_tf", "preprocess_caffe",
           "preprocess_torch", "save_weights", "load_weights",
           "save_safetensors",
           "decodePredictions", "load_flax_variables", "load_flax_msgpack",
           "load_safetensors", "state_dict_to_flax", "ByteBPETokenizer",
           "load_pretrained", "import_hf_llama", "import_hf_bert",
           "import_keras_resnet", "import_keras_vgg",
           "import_keras_inception", "import_keras_xception",
           "read_keras_h5", "merge_into_template", "CheckpointMismatch"]
