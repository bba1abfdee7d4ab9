"""Models of the port."""

from .ernie import ErnieConfig, ErnieForSequenceClassification, ErnieModel
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["ErnieConfig", "ErnieForSequenceClassification", "ErnieModel",
           "LlamaConfig", "LlamaForCausalLM"]
