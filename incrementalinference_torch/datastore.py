"""Blob and data-entry store: binary payloads (images, scans, JSON
documents) attached to graph variables.

Counterpart of ``incrementalinference/jl_tpu/datastore.py``: the
DistributedFactorGraphs blob-store API the reference re-exports
(FolderStore, addBlobStore!, addData!, getData, listBlobEntries) and
``fetchDataJSON``.  Host-side IO only; blobs never reach the device.  Each
variable keeps its entries in ``Variable.data``; ``save_graph`` carries the
entries (not the blobs) along.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .graph import FactorGraph

__all__ = [
    "BlobEntry", "FolderStore", "InMemoryBlobStore", "add_blob_store",
    "get_blob_store", "list_blob_stores", "add_blob", "get_blob",
    "add_data", "get_data", "list_blob_entries", "list_data_entries",
    "delete_data", "fetch_data_json",
]


@dataclass
class BlobEntry:
    """Metadata record pointing a variable at a stored blob (reference
    DFG BlobEntry: id, label, blobstore, hash, mimeType, timestamp)."""

    label: str
    blob_id: str
    blobstore: str
    mime_type: str = "application/octet-stream"
    hash: str = ""
    origin: str = ""
    description: str = ""
    timestamp: float = field(default_factory=time.time)


class InMemoryBlobStore:
    """Ephemeral blob store (tests / scratch)."""

    def __init__(self, key: str = "default"):
        self.key = key
        self._blobs: Dict[str, bytes] = {}

    def put(self, blob_id: str, data: bytes) -> str:
        self._blobs[blob_id] = bytes(data)
        return blob_id

    def get(self, blob_id: str) -> bytes:
        return self._blobs[blob_id]

    def delete(self, blob_id: str) -> None:
        self._blobs.pop(blob_id, None)

    def list(self) -> List[str]:
        return list(self._blobs.keys())


class FolderStore:
    """Filesystem blob store (reference DFG ``FolderStore``): one file per
    blob id under ``folder``."""

    def __init__(self, folder: str, key: str = "data"):
        self.key = key
        self.folder = folder
        os.makedirs(folder, exist_ok=True)

    def _path(self, blob_id: str) -> str:
        return os.path.join(self.folder, blob_id)

    def put(self, blob_id: str, data: bytes) -> str:
        with open(self._path(blob_id), "wb") as f:
            f.write(bytes(data))
        return blob_id

    def get(self, blob_id: str) -> bytes:
        with open(self._path(blob_id), "rb") as f:
            return f.read()

    def delete(self, blob_id: str) -> None:
        try:
            os.remove(self._path(blob_id))
        except FileNotFoundError:
            pass

    def list(self) -> List[str]:
        return sorted(os.listdir(self.folder))


def add_blob_store(fg: FactorGraph, store) -> object:
    """Reference ``addBlobStore!`` — register a store on the graph."""
    if not hasattr(fg, "_blob_stores"):
        fg._blob_stores = {}
    fg._blob_stores[store.key] = store
    return store


def get_blob_store(fg: FactorGraph, key: str = None):
    """Look up a registered store (first one when ``key`` is None)."""
    stores = getattr(fg, "_blob_stores", {})
    if not stores:
        raise KeyError("no blob store registered — call add_blob_store")
    if key is None:
        return next(iter(stores.values()))
    return stores[key]


def list_blob_stores(fg: FactorGraph) -> List[str]:
    """Keys of the graph's registered blob stores (reference DFG
    listBlobStores)."""
    return list(getattr(fg, "_blob_stores", {}).keys())


def add_blob(fg: FactorGraph, data: bytes, store_key: str = None) -> str:
    """Reference ``addBlob!`` — store raw bytes, returns the blob id."""
    store = get_blob_store(fg, store_key)
    blob_id = str(uuid.uuid4())
    store.put(blob_id, data)
    return blob_id


def get_blob(fg: FactorGraph, blob_id: str, store_key: str = None) -> bytes:
    """Fetch raw blob bytes by id (reference getBlob)."""
    store = get_blob_store(fg, store_key)
    return store.get(blob_id)


def add_data(fg: FactorGraph, var_label: str, entry_label: str,
             data: bytes, mime_type: str = "application/octet-stream",
             store_key: str = None, description: str = "") -> BlobEntry:
    """Reference ``addData!(dfg, storekey, varsym, lbl, blob)`` — store the
    blob and attach a BlobEntry to the variable."""
    store = get_blob_store(fg, store_key)
    data = bytes(data)
    blob_id = str(uuid.uuid4())
    store.put(blob_id, data)
    entry = BlobEntry(label=entry_label, blob_id=blob_id,
                      blobstore=store.key, mime_type=mime_type,
                      hash=hashlib.sha256(data).hexdigest(),
                      origin=var_label, description=description)
    fg.var(var_label).data[entry_label] = entry
    return entry


def get_data(fg: FactorGraph, var_label: str, entry_label: str
             ) -> Tuple[BlobEntry, bytes]:
    """Reference ``getData`` — (entry, raw bytes); verifies the hash."""
    entry = fg.var(var_label).data[entry_label]
    data = get_blob_store(fg, entry.blobstore).get(entry.blob_id)
    if entry.hash and hashlib.sha256(data).hexdigest() != entry.hash:
        raise ValueError(
            f"blob hash mismatch for {var_label}/{entry_label}")
    return entry, data


def list_blob_entries(fg: FactorGraph, var_label: str) -> List[str]:
    """Reference ``listBlobEntries``/``listDataEntries``."""
    return list(fg.var(var_label).data.keys())


list_data_entries = list_blob_entries


def delete_data(fg: FactorGraph, var_label: str, entry_label: str
                ) -> BlobEntry:
    """Reference ``deleteData!`` — drop the entry and its stored blob."""
    entry = fg.var(var_label).data.pop(entry_label)
    try:
        get_blob_store(fg, entry.blobstore).delete(entry.blob_id)
    except KeyError:
        pass
    return entry


def fetch_data_json(fg: FactorGraph, var_label: str, entry_label: str):
    """Reference ``fetchDataJSON`` (FGOSUtils.jl:589-596) — parse a JSON
    blob entry."""
    entry, raw = get_data(fg, var_label, entry_label)
    if "json" not in entry.mime_type:
        raise ValueError(f"unknown JSON blob format {entry.mime_type}")
    return json.loads(raw.decode("utf-8"))
