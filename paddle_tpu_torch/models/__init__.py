"""Models of the port."""

from .ernie import ErnieConfig, ErnieForSequenceClassification, ErnieModel
from .llama import LlamaConfig, LlamaForCausalLM
from .ppyoloe import PPYOLOE, PPYOLOEConfig

__all__ = ["ErnieConfig", "ErnieForSequenceClassification", "ErnieModel",
           "LlamaConfig", "LlamaForCausalLM", "PPYOLOE", "PPYOLOEConfig"]
