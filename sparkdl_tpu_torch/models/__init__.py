"""Model families of the port. Only Llama (generation, the serving
engine's slot primitives and the LoRA fine-tune) so far."""

from .llama import LlamaConfig, LlamaModel, generate

__all__ = ["LlamaConfig", "LlamaModel", "generate"]
