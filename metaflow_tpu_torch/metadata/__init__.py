"""Metadata providers: the local JSON provider (the JAX package's default).
The REST metadata service provider is not in the port yet."""

from .metadata import MetaDatum, MetadataProvider
from .local import LocalMetadataProvider

METADATA_PROVIDERS = {
    "local": LocalMetadataProvider,
}

__all__ = [
    "MetaDatum",
    "MetadataProvider",
    "LocalMetadataProvider",
    "METADATA_PROVIDERS",
]
