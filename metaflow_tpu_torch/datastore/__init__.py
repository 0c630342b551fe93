"""Checkpoint storage for the port: the JAX package's pytree blob format
(serializers.py) and a local-directory datastore with the interface of
its FlowDataStore (local.py)."""

from .local import LocalFlowDataStore
from .serializers import deserialize, serialize

__all__ = ["LocalFlowDataStore", "deserialize", "serialize"]
