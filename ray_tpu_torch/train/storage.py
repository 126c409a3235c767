"""Port of ``ray_tpu/train/storage.py``.

Storage abstraction: run/trial/checkpoint dirs on local or remote
filesystems.

Counterpart of the reference's StorageContext (reference:
python/ray/train/_internal/storage.py — every artifact path resolves through
a pyarrow.fs filesystem so ``RunConfig(storage_path="gs://bucket/runs")``
lands checkpoints in object storage).  On a TPU pod this is load-bearing:
VM-local disks vanish with the slice, so checkpoints/experiment state must
live in GCS.

``get_fs(path)`` returns (StorageFS, normalized_path):
- plain paths -> ``_LocalFS`` (os/shutil fast path);
- ``scheme://...`` URIs -> ``_ArrowFS`` over ``pyarrow.fs`` —
  ``FileSystem.from_uri`` handles gs/s3/hdfs/file natively, and anything
  fsspec knows (e.g. ``memory://`` in tests) is wrapped via FSSpecHandler.
"""

from __future__ import annotations

import os
import posixpath
import shutil
from typing import List, Tuple


def is_uri(path: str) -> bool:
    return "://" in str(path)


def join(base: str, *parts: str) -> str:
    if is_uri(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


def expand(path: str) -> str:
    return path if is_uri(path) else os.path.expanduser(path)


class StorageFS:
    """Filesystem surface the train/tune stack uses (tiny by design)."""

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def rmtree(self, path: str) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        """Atomic where the backend allows: object stores publish on close;
        the local impl writes a temp file then renames."""
        raise NotImplementedError

    def merge_dir(self, local: str, remote: str) -> None:
        """Upload the CONTENTS of local into remote without deleting what's
        already there (multi-rank checkpoints merge into one dir)."""
        raise NotImplementedError

    def download_dir(self, remote: str, local: str) -> None:
        raise NotImplementedError


class _LocalFS(StorageFS):
    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def exists(self, path):
        return os.path.exists(path)

    def listdir(self, path):
        return os.listdir(path)

    def rmtree(self, path):
        shutil.rmtree(path, ignore_errors=True)

    def read_bytes(self, path):
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path, data):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def merge_dir(self, local, remote):
        os.makedirs(remote, exist_ok=True)
        shutil.copytree(local, remote, dirs_exist_ok=True)

    def download_dir(self, remote, local):
        shutil.copytree(remote, local, dirs_exist_ok=True)


class _ArrowFS(StorageFS):
    """pyarrow.fs-backed storage (gs://, s3://, file://, or any fsspec
    scheme)."""

    def __init__(self, fs):
        self.fs = fs

    def makedirs(self, path):
        self.fs.create_dir(path, recursive=True)

    def exists(self, path):
        import pyarrow.fs as pafs

        return self.fs.get_file_info(path).type != pafs.FileType.NotFound

    def listdir(self, path):
        import pyarrow.fs as pafs

        sel = pafs.FileSelector(path, recursive=False, allow_not_found=True)
        return [posixpath.basename(i.path) for i in self.fs.get_file_info(sel)]

    def rmtree(self, path):
        try:
            self.fs.delete_dir(path)
        except FileNotFoundError:
            pass

    def read_bytes(self, path):
        with self.fs.open_input_stream(path) as f:
            return f.read()

    def write_bytes(self, path, data):
        # tmp + move keeps the previous file intact if this process dies
        # mid-write (object stores publish atomically on close anyway, but
        # file:// URIs hit pyarrow's LocalFileSystem, which writes in place)
        tmp = path + ".tmp"
        with self.fs.open_output_stream(tmp) as f:
            f.write(data)
        self.fs.move(tmp, path)

    def merge_dir(self, local, remote):
        self.fs.create_dir(remote, recursive=True)
        for root, _dirs, files in os.walk(local):
            rel = os.path.relpath(root, local)
            target = remote if rel == "." else posixpath.join(
                remote, rel.replace(os.sep, "/"))
            self.fs.create_dir(target, recursive=True)
            for name in files:
                with open(os.path.join(root, name), "rb") as src, \
                        self.fs.open_output_stream(
                            posixpath.join(target, name)) as dst:
                    shutil.copyfileobj(src, dst)

    def download_dir(self, remote, local):
        import pyarrow.fs as pafs

        os.makedirs(local, exist_ok=True)
        sel = pafs.FileSelector(remote, recursive=True)
        for info in self.fs.get_file_info(sel):
            rel = posixpath.relpath(info.path, remote)
            dst = os.path.join(local, rel.replace("/", os.sep))
            if info.type == pafs.FileType.Directory:
                os.makedirs(dst, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with self.fs.open_input_stream(info.path) as src, \
                    open(dst, "wb") as f:
                shutil.copyfileobj(src, f)


_LOCAL = _LocalFS()


# ---------------------------------------------------------- conveniences
# One path space for callers: every function takes a local path OR a URI and
# resolves the filesystem internally, so trial/checkpoint paths stay in
# whatever form the user configured (reference: StorageContext keeps
# fs + fs_path pairs; here resolution is cheap enough to do per call).

def makedirs(path: str) -> None:
    fs, p = get_fs(path)
    fs.makedirs(p)


def exists(path: str) -> bool:
    fs, p = get_fs(path)
    return fs.exists(p)


def listdir(path: str) -> List[str]:
    fs, p = get_fs(path)
    return fs.listdir(p)


def rmtree(path: str) -> None:
    fs, p = get_fs(path)
    fs.rmtree(p)


def read_bytes(path: str) -> bytes:
    fs, p = get_fs(path)
    return fs.read_bytes(p)


def write_bytes(path: str, data: bytes) -> None:
    fs, p = get_fs(path)
    fs.write_bytes(p, data)


def merge_dir(local: str, target: str) -> None:
    fs, p = get_fs(target)
    fs.merge_dir(local, p)


def download_dir(source: str, local: str) -> None:
    fs, p = get_fs(source)
    fs.download_dir(p, local)


def get_fs(path: str) -> Tuple[StorageFS, str]:
    """Resolve a storage path/URI to (filesystem, path-on-that-fs).  The
    filesystem object is cached per scheme+authority: rebuilding a GCS
    client (connections, credentials) per checkpoint write would tax every
    report round."""
    path = str(path)
    if not is_uri(path):
        return _LOCAL, os.path.expanduser(path)
    from urllib.parse import urlparse

    parsed = urlparse(path)
    fs = _cached_uri_fs(parsed.scheme, parsed.netloc)
    import pyarrow.fs as pafs

    try:
        _, fs_path = pafs.FileSystem.from_uri(path)
    except Exception:
        import fsspec

        _, fs_path = fsspec.core.url_to_fs(path)
    return fs, fs_path


import functools  # noqa: E402


@functools.lru_cache(maxsize=32)
def _cached_uri_fs(scheme: str, netloc: str) -> "StorageFS":
    import pyarrow as pa
    import pyarrow.fs as pafs

    sample_uri = f"{scheme}://{netloc}/"
    try:
        fs, _ = pafs.FileSystem.from_uri(sample_uri)
    except (pa.lib.ArrowInvalid, OSError, ValueError):
        # schemes pyarrow doesn't speak natively (memory://, mock buckets in
        # tests, any fsspec backend)
        import fsspec

        fsspec_fs, _ = fsspec.core.url_to_fs(sample_uri)
        fs = pafs.PyFileSystem(pafs.FSSpecHandler(fsspec_fs))
    return _ArrowFS(fs)
