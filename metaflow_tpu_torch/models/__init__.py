from . import llama, mixtral

__all__ = ["llama", "mixtral"]
