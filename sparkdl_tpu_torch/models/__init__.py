"""Model families of the port. Only Llama (generation and the serving
engine's slot primitives) so far."""

from .llama import LlamaConfig, LlamaModel, generate

__all__ = ["LlamaConfig", "LlamaModel", "generate"]
