"""Model families of the port. Only Llama generation so far."""

from .llama import LlamaConfig, LlamaModel, generate

__all__ = ["LlamaConfig", "LlamaModel", "generate"]
