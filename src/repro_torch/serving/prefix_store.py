"""Cross-host prefix page store — warm KV prefixes through the object
store.

Counterpart of the reference package's ``serving/prefix_store.py`` (the
port keeps its own copy).  The radix prefix cache only helps requests
landing on the *same* engine; a fleet of queue-fed serving workers sees
the same system prompts on every host.  A completed prompt's full pages
are content-hashed and published to the shared
:class:`~repro_torch.core.storage.ObjectStore`, so a worker admitting a
cold request can *hydrate* its radix cache from pages another worker
computed instead of dispatching prefill.

Key scheme (chained content hash):

- the chain root is ``sha256("repro_torch|" + namespace)``.  The
  ``repro_torch|`` tag keeps the port's pages apart from the reference
  package's (whose root is ``sha256(namespace)``): a page the other
  package's arithmetic wrote passes the shape/dtype check but not the
  port's tokens, so a mixed fleet on one store never hydrates across
  packages.  ``namespace`` must pin everything page bytes depend on:
  architecture, parameter identity (run name / init seed), dtype and
  ``page_size``;
- chunk ``j`` of a prompt (its ``page_size`` tokens) is keyed by
  ``sha256(parent_key || int64 tokens of chunk j)`` where ``parent_key``
  is chunk ``j-1``'s key, so a chunk's key commits to the entire prefix,
  like a radix-tree path, and hydration is a walk from chunk 0 until a
  miss.  Chunk keys and content digests are computed exactly as the
  reference computes them from a given root.

Page payloads are the page's slice of every pool leaf (``k_pages`` /
``v_pages``, or MLA's latent ``kv_pages``), ``npz``-serialized with an
embedded content digest.  numpy has no bfloat16, so a bf16 leaf travels
as its ``int16`` view (:func:`host_page` / :func:`device_page`); the
fetch template (:func:`host_dtype`) carries the same encoded dtype.

Consistency: publication is atomic per page (temp-file + rename) and
last-writer-wins over identical bytes; a page is published only once
fully written and never mutated afterwards (copy-on-write privatizes
shared pages first).  Store-side eviction is the age-based
:meth:`PrefixStore.sweep`, with pin markers protecting a handoff's chain.
A fetched page is checked against its digest and the expected
shape/dtype; a corrupt, truncated, swept or mismatched page is a miss.
"""

from __future__ import annotations

import hashlib
import io
import logging
import queue
import threading
import time
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.worker import backoff_delay

_LOG = logging.getLogger(__name__)

# the chain root's framework tag (see the module docstring)
ROOT_TAG = "repro_torch|"


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype a pool leaf of ``dtype`` travels as (bf16 -> int16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_page(t: torch.Tensor) -> np.ndarray:
    """Copy one page slice into a host numpy array of its own (bf16 as its
    int16 view).  Always a copy, on the CPU too, where ``.cpu()`` would
    return the pool's own memory: the background write must see the page
    as it was at submit time, not as a later dispatch rewrote it."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def device_page(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The host tensor a fetched page leaf stands for (int16 -> bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _retry_transient(op, *, key: str, attempts: int = 4,
                     base: float = 0.01, cap: float = 0.25):
    """Retry a store operation through *transient* faults
    (``ConnectionError`` — what chaos ``flaky_storage`` and a real S3
    SDK raise for retryable errors) with capped backoff deterministically
    jittered by ``key``.  ``FileNotFoundError`` (a plain miss) and every
    other error propagate immediately; a ``ConnectionError`` that
    survives all attempts propagates too, so callers keep their
    miss-vs-crash decision."""
    for attempt in range(1, attempts + 1):
        try:
            return op()
        except ConnectionError:
            if attempt == attempts:
                raise
            time.sleep(backoff_delay(base, attempt, cap=cap, key=key))


class PrefixStore:
    """Content-addressed KV prefix pages over an object store."""

    def __init__(self, store, namespace: str, key_prefix: str = "kvprefix"):
        self.store = store
        self.namespace = str(namespace)
        self.key_prefix = key_prefix.rstrip("/")
        self._root = hashlib.sha256(
            (ROOT_TAG + self.namespace).encode("utf-8")).hexdigest()
        # fetched blobs whose embedded sha256 content digest did not match
        # (bit flips, wrong-content writes): counted misses, never hydrated
        self.hash_mismatches = 0
        # hydration observability: store round-trips attempted by fetch()
        # and the blob bytes they actually moved (misses move 0)
        self.fetch_ops = 0
        self.bytes_fetched = 0

    # ------------------------------------------------------------- keys
    def root_key(self) -> str:
        return self._root

    def child_key(self, parent_key: str, chunk: Sequence[int]) -> str:
        h = hashlib.sha256()
        h.update(parent_key.encode("ascii"))
        h.update(np.asarray(chunk, np.int64).tobytes())
        return h.hexdigest()

    def _object_key(self, page_key: str) -> str:
        # shard the flat hash space one level deep, S3-style
        return f"{self.key_prefix}/{page_key[:2]}/{page_key}"

    # ------------------------------------------------------- page payloads
    @staticmethod
    def content_digest(page_key: str, arrays: Dict[str, np.ndarray]) -> str:
        """sha256 over the page key and every leaf's name/dtype/shape/bytes
        — binds a blob's *content* to the key it was published under, so a
        bit-flipped or wrong-content object can be rejected at fetch."""
        h = hashlib.sha256()
        h.update(page_key.encode("ascii"))
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode("utf-8"))
            h.update(str(a.dtype).encode("ascii"))
            h.update(repr(a.shape).encode("ascii"))
            h.update(a.tobytes())
        return h.hexdigest()

    @staticmethod
    def pack(arrays: Dict[str, np.ndarray], page_key: Optional[str] = None) -> bytes:
        bio = io.BytesIO()
        if page_key is not None:
            arrays = dict(
                arrays,
                __digest__=np.array(PrefixStore.content_digest(page_key, arrays)),
            )
        np.savez(bio, **arrays)
        return bio.getvalue()

    @staticmethod
    def unpack(blob: bytes) -> Dict[str, np.ndarray]:
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}

    # ------------------------------------------------------------ protocol
    def exists(self, page_key: str) -> bool:
        key = self._object_key(page_key)
        return _retry_transient(lambda: self.store.exists(key), key=key)

    def publish(self, page_key: str, arrays: Dict[str, np.ndarray]) -> None:
        """Write one page's leaves unconditionally (atomic put), with the
        content digest embedded.  Callers probe :meth:`exists` first to
        skip redundant writes; a lost race is a benign last-writer-wins
        overwrite of identical bytes.  Every caller retries this put
        (:class:`AsyncPublisher`)."""
        self.store.put_bytes(  # dslint: disable=R1(every caller retries this put: AsyncPublisher._publish_with_retry re-attempts with content-keyed backoff, and the only synchronous caller is that retry loop)
            self._object_key(page_key), self.pack(arrays, page_key=page_key)
        )

    def fetch(
        self, page_key: str, like: Dict[str, np.ndarray]
    ) -> Optional[Dict[str, np.ndarray]]:
        """Read one page's leaves, or None on miss/incompatibility.

        ``like`` maps leaf name -> an array of the expected per-page
        shape/dtype; a blob whose leaves do not match exactly is a miss
        rather than corrupting the pool."""
        key = self._object_key(page_key)
        self.fetch_ops += 1
        try:
            # transient faults are retried first, so a flaky-storage
            # ConnectionError (an OSError) is not miscounted as a miss
            blob = _retry_transient(lambda: self.store.get_bytes(key), key=key)
        except (FileNotFoundError, OSError):
            # a plain miss, or the exists/read race against a sweep:
            # hydration is best-effort, so a swept page is a miss
            return None
        self.bytes_fetched += len(blob)
        try:
            arrays = self.unpack(blob)
        except (ValueError, OSError, zipfile.BadZipFile):
            # BadZipFile is not a ValueError/OSError: np.load raises it for
            # a PK-magic blob whose zip structure is truncated
            return None
        # the blob must carry a digest binding its bytes to THIS page key:
        # absent or mismatched is a counted miss, never hydrated
        digest = arrays.pop("__digest__", None)
        if digest is None or str(digest[()]) != self.content_digest(page_key, arrays):
            self.hash_mismatches += 1
            return None
        if set(arrays) != set(like):
            return None
        for name, ref in like.items():
            if arrays[name].shape != ref.shape or arrays[name].dtype != ref.dtype:
                return None
        return arrays

    # ------------------------------------------------------------- eviction
    def publisher(self) -> "AsyncPublisher":
        """A background publisher bound to this store (one per call)."""
        return AsyncPublisher(self)

    def _pin_key(self, page_key: str) -> str:
        # pins live OUTSIDE key_prefix/ (a listing of "kvprefix/" never
        # sees "kvprefix-pins/..."), so the sweep's two walks are disjoint
        return f"{self.key_prefix}-pins/{page_key[:2]}/{page_key}"

    def pin(self, page_key: str) -> None:
        """Refresh a page's sweep protection: an empty marker object whose
        mtime restarts the page's TTL clock.  A prefill worker pins every
        chain key of a handoff it enqueues, so a TTL sweep between the
        enqueue and the decode worker's fetch cannot delete those pages.
        Pins expire by the same TTL and are never removed explicitly."""
        key = self._pin_key(page_key)
        _retry_transient(lambda: self.store.put_bytes(key, b""), key=key)

    def sweep(self, ttl_s: float, now: Optional[float] = None) -> int:
        """Delete every page under ``key_prefix/`` older than ``ttl_s``
        seconds (by object mtime, wall clock) and return the count.
        Pages are immutable and content-addressed, so deleting a cold one
        is always safe; a sweep racing a hydration is a fetch miss.
        ``ttl_s=0`` clears the whole prefix.  Keys are content hashes, so
        both packages' pages are swept alike.

        Pages with a *fresh* pin marker are exempt even when expired;
        expired markers are deleted too (not counted: the return value is
        pages only)."""
        if now is None:
            now = time.time()
        pinned = set()
        for info in list(self.store.list(self.key_prefix + "-pins/")):
            if now - info.mtime < ttl_s:
                pinned.add(info.key.rsplit("/", 1)[-1])
            else:
                self.store.delete(info.key)
        swept = 0
        for info in list(self.store.list(self.key_prefix + "/")):
            if info.key.rsplit("/", 1)[-1] in pinned:
                continue
            if now - info.mtime >= ttl_s:
                self.store.delete(info.key)
                swept += 1
        return swept


class AsyncPublisher:
    """Single-worker background queue in front of :meth:`PrefixStore.publish`.

    Only the *write* (npz pack + ``put_bytes``) runs off the engine's
    thread; everything that affects engine state or counters stays
    synchronous at submit time:

    - the caller pulls the page's device arrays to host numpy BEFORE the
      write is queued (a pool page can be reissued and rewritten while the
      write waits), so the worker thread only ever sees numpy arrays and
      never touches the device;
    - the ``exists()`` probe, the published-key memo and the
      ``prefix_store_pages_published`` counter stay on the submit path, so
      counters are deterministic.

    A failed put backs off (capped exponential, jittered by the page's
    content key with ``backoff_delay``) and is re-attempted up to
    ``max_attempts`` times before the page is dropped (it stays cold for
    other workers).  ``retries`` counts re-attempts, ``errors`` dropped
    pages, ``dedup_hits`` submits of a key already pending.  Callers
    :meth:`flush` at the drain seams (engine drain, lease end, teardown).
    The worker thread is a daemon started lazily; after :meth:`close` a
    new submit restarts it."""

    _STOP = object()

    def __init__(
        self,
        store: PrefixStore,
        *,
        max_attempts: int = 4,
        retry_base: float = 0.02,
        retry_cap: float = 0.5,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.store = store
        self.max_attempts = int(max_attempts)
        self.retry_base = float(retry_base)
        self.retry_cap = float(retry_cap)
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.errors = 0
        self.retries = 0
        # content keys submitted but not yet written: a second submit of a
        # pending key is a byte-identical duplicate (keys are content
        # hashes), dropped before any snapshot or pack work
        self._pending: set = set()
        self.dedup_hits = 0

    def submit(self, page_key: str, arrays) -> bool:
        """Enqueue one page write.  ``arrays`` is a host snapshot dict or a
        zero-arg callable producing one; a callable runs HERE, on the
        caller's thread, and only when the key is not already pending.
        Returns False (counting a ``dedup_hits``) for a pending key."""
        with self._lock:
            if page_key in self._pending:
                self.dedup_hits += 1
                return False
            self._pending.add(page_key)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="kvprefix-publisher", daemon=True
                )
                self._thread.start()
        try:
            if callable(arrays):
                arrays = arrays()
        except BaseException:
            with self._lock:
                self._pending.discard(page_key)
            raise
        self._q.put((page_key, arrays))
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                page_key, arrays = item
                try:
                    self._publish_with_retry(page_key, arrays)
                finally:
                    with self._lock:
                        self._pending.discard(page_key)
            except Exception:  # noqa: BLE001 - best-effort, never kill the worker
                self.errors += 1
                _LOG.exception("async prefix-store publish failed (dropped)")
            finally:
                self._q.task_done()

    def _publish_with_retry(self, page_key: str, arrays: Dict[str, np.ndarray]) -> None:
        for attempt in range(1, self.max_attempts + 1):
            try:
                self.store.publish(page_key, arrays)
                return
            except Exception:  # noqa: BLE001 - transient store faults expected
                if attempt == self.max_attempts:
                    self.errors += 1
                    _LOG.exception(
                        "async prefix-store publish of %s failed after "
                        "%d attempts (dropped)", page_key, attempt,
                    )
                    return
                self.retries += 1
                time.sleep(backoff_delay(self.retry_base, attempt,
                                         cap=self.retry_cap, key=page_key))

    def flush(self) -> None:
        """Block until every submitted write has been attempted."""
        self._q.join()

    def close(self) -> None:
        """Flush, then stop the worker thread (restartable)."""
        self.flush()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                self._q.put(self._STOP)
                self._thread.join()
            self._thread = None
