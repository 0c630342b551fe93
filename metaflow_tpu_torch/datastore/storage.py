"""Byte-level storage backends (the JAX package's datastore/storage.py).

Reference behavior: metaflow/datastore/datastore_storage.py (DataStoreStorage
ABC: save_bytes:206 / load_bytes:243 / list_content / is_file). The port
has the local backend; the GCS one raises until it is ported.
"""

import os
import shutil
from tempfile import NamedTemporaryFile

from .. import knobs


class CloseAfterUse(object):
    """Context manager tying the lifetime of fetched data to a `with` block."""

    def __init__(self, data, closer=None):
        self.data = data
        self._closer = closer

    def __enter__(self):
        return self.data

    def __exit__(self, *args):
        if self._closer:
            self._closer.close()


class DataStoreStorage(object):
    """ABC for byte storage: hierarchical keys relative to datastore_root."""

    TYPE = None

    def __init__(self, root=None):
        self.datastore_root = root

    @classmethod
    def get_datastore_root_from_config(cls, echo=None, create_on_absent=True):
        raise NotImplementedError

    def full_uri(self, path):
        return os.path.join(self.datastore_root, path)

    def path_join(self, *components):
        return os.path.join(*components)

    def path_split(self, path):
        return path.split("/")

    def basename(self, path):
        return os.path.basename(path)

    def dirname(self, path):
        return os.path.dirname(path)

    def is_file(self, paths):
        """Return list of bools: does each path exist as a file."""
        raise NotImplementedError

    def info_file(self, path):
        """Return (exists, metadata_dict)."""
        raise NotImplementedError

    def size_file(self, path):
        raise NotImplementedError

    def list_content(self, paths):
        """Yield (path, is_file) under each given prefix (one level)."""
        raise NotImplementedError

    def save_bytes(self, path_and_bytes_iter, overwrite=False, len_hint=0):
        """Save (path, (byteobj, metadata|None)) or (path, byteobj) pairs."""
        raise NotImplementedError

    def load_bytes(self, paths):
        """Return CloseAfterUse yielding (path, local_file_or_None, metadata)."""
        raise NotImplementedError

    def delete(self, paths):
        raise NotImplementedError


class LocalStorage(DataStoreStorage):
    TYPE = "local"

    @classmethod
    def get_datastore_root_from_config(cls, echo=None, create_on_absent=True):
        from ..util import get_tpuflow_root

        root = get_tpuflow_root()
        if create_on_absent:
            os.makedirs(root, exist_ok=True)
        return root

    def _abs(self, path):
        return os.path.join(self.datastore_root, path)

    def is_file(self, paths):
        return [os.path.isfile(self._abs(p)) for p in paths]

    def info_file(self, path):
        p = self._abs(path)
        if os.path.isfile(p):
            return True, {}
        return False, None

    def size_file(self, path):
        p = self._abs(path)
        try:
            return os.path.getsize(p)
        except OSError:
            return None

    def list_content(self, paths):
        results = []
        for path in paths:
            full = self._abs(path)
            if not os.path.isdir(full):
                continue
            for name in sorted(os.listdir(full)):
                child = os.path.join(path, name)
                results.append((child, os.path.isfile(self._abs(child))))
        return results

    def save_bytes(self, path_and_bytes_iter, overwrite=False, len_hint=0):
        for path, payload in path_and_bytes_iter:
            if isinstance(payload, tuple):
                byte_obj, _meta = payload
            else:
                byte_obj = payload
            full = self._abs(path)
            if os.path.exists(full) and not overwrite:
                if hasattr(byte_obj, "close"):
                    byte_obj.close()
                continue
            os.makedirs(os.path.dirname(full), exist_ok=True)
            # atomic write: temp file + rename, safe under concurrent tasks
            try:
                with NamedTemporaryFile(
                    dir=os.path.dirname(full), delete=False
                ) as tmp:
                    if hasattr(byte_obj, "read"):
                        shutil.copyfileobj(byte_obj, tmp, length=1 << 20)
                    else:
                        tmp.write(byte_obj)
                    tmpname = tmp.name
            finally:
                if hasattr(byte_obj, "close"):
                    byte_obj.close()
            os.replace(tmpname, full)

    def load_bytes(self, paths):
        def iterator():
            for path in paths:
                full = self._abs(path)
                if os.path.isfile(full):
                    yield path, full, None
                else:
                    yield path, None, None

        return CloseAfterUse(iterator())

    def delete(self, paths):
        for path in paths:
            try:
                os.unlink(self._abs(path))
            except OSError:
                pass


class GCSStorage(DataStoreStorage):
    """Google Cloud Storage backend (root = 'gs://bucket/prefix'). The
    JAX package's backend rides its own raw-HTTP transfer engine, which
    is not in the port yet: selecting it raises."""

    TYPE = "gs"

    def __init__(self, root=None):
        raise NotImplementedError(
            "the gs datastore (%s) is not in the port yet: use the local "
            "datastore" % (root,))

    @classmethod
    def get_datastore_root_from_config(cls, echo=None, create_on_absent=True):
        cls(knobs.get_str("TPUFLOW_DATASTORE_SYSROOT_GS"))


STORAGE_BACKENDS = {"local": LocalStorage, "gs": GCSStorage}
