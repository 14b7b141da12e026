"""Object store — the framework's S3 analogue.

The port's own copy of the reference package's ``core/storage.py`` (the
port imports nothing of the reference): the same keys, atomic writes and
listing over a local-filesystem root, so a store written by one package
is read by the other.

DS keeps *everything* durable in S3: input data, outputs, exported logs,
and the files that the ``CHECK_IF_DONE`` idempotent-restart machinery
counts.  We reproduce that contract over a local filesystem root with
S3-like semantics:

- flat key space (``bucket/key`` → ``root/key``), prefix listing,
- atomic writes (temp file + ``os.replace``) so a preempted worker can
  never leave a half-written "done" artifact,
- object metadata (size, mtime) for ``MIN_FILE_SIZE_BYTES`` checks.

Swapping in real S3/GCS is a matter of re-implementing this one class;
every other subsystem talks only to :class:`ObjectStore`.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class ObjectInfo:
    key: str
    size: int
    mtime: float


class ObjectStore:
    """Local-filesystem object store with S3-style keys."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths -----------------------------------------------------------
    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"invalid object key: {key!r}")
        return os.path.join(self.root, key)

    # -- writes ----------------------------------------------------------
    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic on POSIX
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put_text(self, key: str, text: str) -> None:
        self.put_bytes(key, text.encode("utf-8"))

    def put_json(self, key: str, obj) -> None:
        self.put_text(key, json.dumps(obj, indent=2, sort_keys=True))

    def upload_file(self, local_path: str, key: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        os.close(fd)
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, path)

    # -- reads -----------------------------------------------------------
    def get_bytes(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def get_text(self, key: str) -> str:
        return self.get_bytes(key).decode("utf-8")

    def get_json(self, key: str):
        return json.loads(self.get_text(key))

    def download_file(self, key: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        shutil.copyfile(self._path(key), local_path)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def head(self, key: str) -> Optional[ObjectInfo]:
        path = self._path(key)
        if not os.path.isfile(path):
            return None
        st = os.stat(path)
        return ObjectInfo(key=key, size=st.st_size, mtime=st.st_mtime)

    def list(self, prefix: str = "") -> Iterator[ObjectInfo]:
        """Yield objects under ``prefix``, sorted by key (like S3 ListObjects)."""
        base = self.root
        results = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in filenames:
                if fn.startswith(".tmp-"):
                    continue
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, base).replace(os.sep, "/")
                if key.startswith(prefix):
                    st = os.stat(full)
                    results.append(ObjectInfo(key=key, size=st.st_size, mtime=st.st_mtime))
        results.sort(key=lambda o: o.key)
        yield from results

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.isfile(path):
            os.unlink(path)

    def delete_prefix(self, prefix: str) -> int:
        n = 0
        for info in list(self.list(prefix)):
            self.delete(info.key)
            n += 1
        return n
