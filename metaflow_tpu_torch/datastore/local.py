"""A flow datastore on a local directory, for runs outside a flow: the
port's checkpoint manager (training/checkpoint.py), flight recorder
(telemetry.py) and streamed corpus (data/) take one where a flow step
hands them the run's own FlowDataStore.

`LocalFlowDataStore(flow_name, root)` is a FlowDataStore over the local
backend rooted at `root`: the layout and blob format of the JAX
package's local datastore, so either package's FlowDataStore over the
same root reads what the other wrote.
"""

from .cas import ContentAddressedStore
from .flow_datastore import FlowDataStore
from .storage import LocalStorage

__all__ = ["ContentAddressedStore", "LocalFlowDataStore", "LocalStorage"]


class LocalFlowDataStore(FlowDataStore):
    """FlowDataStore of one flow under the local directory `root`."""

    def __init__(self, flow_name, root):
        super().__init__(flow_name, LocalStorage, ds_root=root)
