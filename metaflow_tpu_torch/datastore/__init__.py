"""The artifact datastore: byte storage (storage.py), the
content-addressed blob store (cas.py), per-task artifact manifests
(task_datastore.py), the per-flow datastore (flow_datastore.py) and the
artifact formats (serializers.py), as the JAX package lays them out.
local.py keeps a local-directory FlowDataStore for runs outside a flow."""

from .storage import DataStoreStorage, LocalStorage, GCSStorage, STORAGE_BACKENDS
from .cas import ContentAddressedStore
from .task_datastore import TaskDataStore, MAX_ATTEMPTS
from .flow_datastore import FlowDataStore
from .local import LocalFlowDataStore
from .serializers import deserialize, serialize

__all__ = [
    "DataStoreStorage",
    "LocalStorage",
    "GCSStorage",
    "STORAGE_BACKENDS",
    "ContentAddressedStore",
    "TaskDataStore",
    "FlowDataStore",
    "MAX_ATTEMPTS",
    "LocalFlowDataStore",
    "deserialize",
    "serialize",
]
