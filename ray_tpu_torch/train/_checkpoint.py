"""Port of ``ray_tpu/train/_checkpoint.py``.

Checkpoint: a directory of files, addressable locally or in shared storage.

Counterpart of the reference's ``ray.train.Checkpoint`` (reference:
python/ray/train/_checkpoint.py:56 — directory + pyarrow.fs filesystem).
TPU-first deltas: none needed at this layer — checkpoints are host-side
artifacts; device state enters/leaves via the user's save/restore code (orbax
or plain numpy) writing into the checkpoint directory.

The filesystem seam is a tiny protocol (copy_dir/upload/download/exists)
defaulting to the local filesystem, so a GCS/pyarrow.fs backend can slot in
without touching callers.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Iterator, Optional


# One filesystem abstraction for the whole train/tune stack: the local
# backend lives in ray_tpu_torch.train.storage (URI backends resolve there too).
from ray_tpu_torch.train.storage import _LocalFS as _LocalFileSystem  # noqa: E402
from ray_tpu_torch.train.storage import _LOCAL as _DEFAULT_FS  # noqa: E402


class Checkpoint:
    """A directory of files produced by training (reference:
    train/_checkpoint.py:56).

    Usage (inside a train loop)::

        with tempfile.TemporaryDirectory() as d:
            save_params(d, params)            # user serialization
            train.report(metrics, checkpoint=Checkpoint.from_directory(d))

    Restoring::

        ckpt = train.get_checkpoint()
        if ckpt:
            with ckpt.as_directory() as d:
                params = load_params(d)
    """

    def __init__(self, path: str, filesystem=None):
        self.path = str(path)
        self.filesystem = filesystem or _DEFAULT_FS

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """A checkpoint living in remote storage (gs://, s3://, ...)."""
        return cls(uri)

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Yield a local directory with the checkpoint contents.  If the
        checkpoint already lives on a local path, yields it directly (no
        copy); otherwise downloads to a temp dir cleaned up on exit."""
        from ray_tpu_torch.train import storage

        if not storage.is_uri(self.path) and \
                isinstance(self.filesystem, _LocalFileSystem) and \
                os.path.isdir(self.path):
            yield self.path
            return
        tmp = tempfile.mkdtemp(prefix="rtpu-ckpt-")
        try:
            self._download(tmp)
            yield tmp
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize into ``path`` (or a fresh temp dir) and return it."""
        target = path or tempfile.mkdtemp(prefix="rtpu-ckpt-")
        self._download(target)
        return target

    def _download(self, target: str) -> None:
        import time

        from ray_tpu_torch.train import storage
        from ray_tpu_torch.train._metrics import train_metrics

        t0 = time.perf_counter()
        if storage.is_uri(self.path):
            storage.download_dir(self.path, target)
        else:
            self.filesystem.download_dir(self.path, target)
        train_metrics()["ckpt_restore"].observe(time.perf_counter() - t0)

    def __repr__(self):
        return f"Checkpoint({self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self):
        return hash(self.path)
