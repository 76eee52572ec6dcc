"""Cloud object-storage dataset IO (the JAX package's
``datasets/cloud_io.py``, kept as its own copy): gs:// and s3:// URL
readers.

Ref: deeplearning4j-scaleout/deeplearning4j-aws/.../s3/reader/
{S3Downloader,BucketIterator,BaseS3DataSetIterator}.java: the reference
ships S3 bucket readers that stream dataset files and keys. Here the
seam is a client registered per URL scheme:

- ``HttpRangeClient`` maps gs://bucket/key and s3://bucket/key onto the
  providers' public HTTPS endpoints and reads with Range requests
  (unsigned: public buckets; pass ``headers`` for bearer or SigV4 auth
  fronted by a proxy). The tests run offline against a registered mock
  client; the URL-to-request mapping is tested without a request.
- ``register_client(scheme, client)`` plugs in any other transport (a
  FUSE mount, a signed-URL issuer, a test mock).

``read_url`` / ``open_url`` / ``fetch_to_cache`` are the consumer API;
the record readers (``datasets/records.py``), the MNIST and CIFAR / LFW
fetchers and the streaming input pipeline accept cloud URLs through
them.
"""

from __future__ import annotations

import io
import os
import threading
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional
from xml.etree import ElementTree

__all__ = [
    "CloudStorageClient", "HttpRangeClient", "register_client",
    "client_for", "is_cloud_url", "read_url", "open_url",
    "fetch_to_cache", "list_url", "BucketIterator", "S3Downloader",
]


def _split_url(url: str):
    scheme, rest = url.split("://", 1)
    bucket, _, key = rest.partition("/")
    return scheme.lower(), bucket, key


def is_cloud_url(source) -> bool:
    return isinstance(source, str) and "://" in source


class CloudStorageClient:
    """Transport protocol: byte-range reads + key listing."""

    def read(self, url: str, start: Optional[int] = None,
             length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def list(self, url: str) -> List[str]:
        """URLs of objects under a prefix URL."""
        raise NotImplementedError

    def exists(self, url: str) -> bool:
        try:
            self.read(url, start=0, length=1)
            return True
        except Exception as e:  # noqa: BLE001 — transport error == absent
            # 416 Range Not Satisfiable = a real but ZERO-BYTE object
            return getattr(e, "code", getattr(e, "status", None)) == 416


class HttpRangeClient(CloudStorageClient):
    """gs:// and s3:// over the providers' public HTTPS endpoints.

    gs://b/k  -> https://storage.googleapis.com/b/k
    s3://b/k  -> https://b.s3.amazonaws.com/k
    http(s):// passes through. Range reads use the standard Range header.
    """

    def __init__(self, headers: Optional[Dict[str, str]] = None,
                 timeout: float = 60.0):
        self.headers = dict(headers or {})
        self.timeout = timeout

    def _endpoint(self, url: str) -> str:
        if url.startswith(("http://", "https://")):
            return url
        scheme, bucket, key = _split_url(url)
        key = urllib.parse.quote(key, safe="/")  # spaces, '#', non-ASCII
        if scheme == "gs":
            return f"https://storage.googleapis.com/{bucket}/{key}"
        if scheme == "s3":
            return f"https://{bucket}.s3.amazonaws.com/{key}"
        raise ValueError(f"Unsupported scheme in {url!r}")

    def read(self, url, start=None, length=None) -> bytes:
        req = urllib.request.Request(self._endpoint(url),
                                     headers=dict(self.headers))
        if length is not None and start is None:
            start = 0  # "first N bytes", never a silent full download
        if start is not None:
            end = "" if length is None else str(start + length - 1)
            req.add_header("Range", f"bytes={start}-{end}")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            data = r.read()
            if start is not None and r.status == 200:
                # server ignored the Range header (plain HTTP hosts,
                # some redirect targets): slice the full body ourselves
                # so the caller never mistakes bytes[0:N] for [start:..]
                data = (data[start:start + length] if length is not None
                        else data[start:])
            return data

    def list(self, url) -> List[str]:
        """List object keys under a prefix via the buckets' XML listing
        (S3 ListObjectsV2 / GCS XML API share the response shape),
        following continuation markers — responses cap at 1000 keys."""
        scheme, bucket, key = _split_url(url)
        if scheme not in ("gs", "s3"):
            raise ValueError(f"Cannot list {url!r}")
        prefix = urllib.parse.quote(key, safe="/")
        base = (f"https://storage.googleapis.com/{bucket}/" if scheme == "gs"
                else f"https://{bucket}.s3.amazonaws.com/")
        keys: List[str] = []
        token: Optional[str] = None
        while True:
            q = f"?list-type=2&prefix={prefix}" if scheme == "s3" \
                else f"?prefix={prefix}"
            if token:
                q += ("&continuation-token=" if scheme == "s3"
                      else "&marker=") + urllib.parse.quote(token)
            req = urllib.request.Request(base + q,
                                         headers=dict(self.headers))
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                tree = ElementTree.fromstring(r.read())
            ns = (tree.tag.split("}")[0] + "}"
                  if tree.tag.startswith("{") else "")
            page = [el.text for el in tree.iter(f"{ns}Key")]
            keys.extend(page)
            truncated = next(tree.iter(f"{ns}IsTruncated"), None)
            if truncated is None or truncated.text != "true" or not page:
                break
            nxt = next(tree.iter(f"{ns}NextContinuationToken"), None)
            token = nxt.text if nxt is not None else page[-1]
        return [f"{scheme}://{bucket}/{k}" for k in keys]


_CLIENTS: Dict[str, CloudStorageClient] = {}


def register_client(scheme: str, client: CloudStorageClient) -> None:
    _CLIENTS[scheme.lower()] = client


def client_for(url: str) -> CloudStorageClient:
    scheme = url.split("://", 1)[0].lower()
    if scheme not in _CLIENTS:
        if scheme in ("gs", "s3", "http", "https"):
            _CLIENTS[scheme] = HttpRangeClient()
        else:
            raise ValueError(
                f"No cloud-storage client registered for scheme "
                f"{scheme!r}; call cloud_io.register_client")
    return _CLIENTS[scheme]


def read_url(url: str, start: Optional[int] = None,
             length: Optional[int] = None) -> bytes:
    return client_for(url).read(url, start=start, length=length)


def open_url(url: str) -> io.BytesIO:
    return io.BytesIO(read_url(url))


def list_url(url: str) -> List[str]:
    return client_for(url).list(url)


# per-target-path download dedup locks (in-process reader threads)
_fetch_locks_guard = threading.Lock()
_fetch_locks: Dict[str, threading.Lock] = {}


def fetch_to_cache(url: str, cache_dir: Optional[str] = None) -> Path:
    """Download once into the local dataset cache and return the path
    (the S3Downloader role for fetchers that want a file on disk).

    The cache file commits through ``resilience/atomic.py`` (anything
    that persists state does): a crash or a
    chaos-injected truncation mid-download can never leave a torn file
    at the final path to be loaded as truth later — readers see either
    no cache entry (refetch) or the complete object.

    Concurrent fetches of the SAME url (the input pipeline runs
    parallel reader threads; two sources may share a file) serialize on
    a per-target lock so the object downloads once; racing writers the
    lock cannot see (other processes sharing the cache dir) each commit
    through their own ``unique=True`` tmp — last rename wins whole,
    nobody renames a rival's half-written tmp.
    """
    cache = Path(cache_dir or os.environ.get(
        "DL4J_TPU_CACHE", Path.home() / ".deeplearning4j_tpu" / "cache"))
    cache.mkdir(parents=True, exist_ok=True)
    _, bucket, key = _split_url(url)
    target = cache / bucket / key
    # keys come from config/remote listings: never let ../ segments write
    # outside the cache root
    cache_root = cache.resolve()
    if not target.resolve().is_relative_to(cache_root):
        raise ValueError(f"Key {key!r} escapes the cache directory")
    with _fetch_locks_guard:
        lock = _fetch_locks.setdefault(str(target), threading.Lock())
    try:
        with lock:
            if not target.exists():
                target.parent.mkdir(parents=True, exist_ok=True)
                from deeplearning4j_tpu_torch.resilience.atomic import atomic_path
                data = read_url(url)
                with atomic_path(target, unique=True) as tmp:
                    tmp.write_bytes(data)
    finally:
        # drop the entry — a per-file lock is only needed until the file
        # exists, and a long-lived trainer streaming a large corpus
        # would otherwise intern one lock per file for process lifetime.
        # A waiter still holding the popped lock races a fresh one
        # harmlessly: each commits whole via its own unique tmp.
        with _fetch_locks_guard:
            _fetch_locks.pop(str(target), None)
    return target


def search_data_url(*names: str) -> Optional[Path]:
    """Shared fetcher fallback: when ``DL4J_TPU_DATA_URL`` names a cloud
    prefix (gs://bucket/data, s3://...), fetch the first available
    candidate file into the local cache and return its path. Used by the
    MNIST/CIFAR/LFW fetchers after their local search paths miss."""
    base_url = os.environ.get("DL4J_TPU_DATA_URL", "")
    if not base_url:
        return None
    for n in names:
        try:
            return fetch_to_cache(f"{base_url.rstrip('/')}/{n}")
        except Exception:  # noqa: BLE001 — try the next candidate name
            continue
    return None


class S3Downloader:
    """Reference-named facade (ref: s3/reader/S3Downloader.java)."""

    def __init__(self, client: Optional[CloudStorageClient] = None):
        self._client = client

    def download(self, url: str, dest: str) -> Path:
        data = (self._client or client_for(url)).read(url)
        p = Path(dest)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        return p


class BucketIterator:
    """Iterate the objects under a bucket/prefix URL, yielding per-object
    byte payloads (ref: s3/reader/BucketIterator.java — iterates keys and
    hands S3Objects to a BucketKeyListener)."""

    def __init__(self, prefix_url: str,
                 client: Optional[CloudStorageClient] = None):
        self.prefix_url = prefix_url
        self._client = client or client_for(prefix_url)
        self._keys: Optional[List[str]] = None
        self._pos = 0

    def _ensure(self):
        if self._keys is None:
            self._keys = self._client.list(self.prefix_url)

    def __iter__(self):
        self._ensure()
        self._pos = 0
        return self

    def __next__(self) -> bytes:
        self._ensure()
        if self._pos >= len(self._keys):
            raise StopIteration
        url = self._keys[self._pos]
        self._pos += 1
        return self._client.read(url)

    def keys(self) -> List[str]:
        self._ensure()
        return list(self._keys)
