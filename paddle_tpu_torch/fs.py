"""Local filesystem helpers: the part of ``paddle_tpu/fs.py``'s
``LocalFS`` that ``resilience.CheckpointPolicy`` uses (``mkdirs``,
``delete``, ``is_exist``, ``ls_dir`` and the crash-safe
``atomic_rename``). ``HDFSClient`` and the rest of the shell helpers
are ROADMAP A11."""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple

__all__ = ["LocalFS", "FSFileNotExistsError"]


class FSFileNotExistsError(Exception):
    pass


class LocalFS:
    """Reference fs.cc localfs_* functions."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        """(dirs, files), the reference's split listing."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for e in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, e)) else files).append(e)
        return dirs, files

    def is_exist(self, path) -> bool:
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.isfile(path):
            os.remove(path)

    def atomic_rename(self, src, dst):
        """Crash-safe publication: rename src over dst, durable (the
        parent directory fsync'd). For files and a fresh dst this is one
        atomic ``os.replace``. POSIX cannot rename over a non-empty
        directory, so an existing dst directory is first moved aside and
        deleted after the publish: a crash in between leaves dst absent,
        never partial (``CheckpointPolicy`` never re-publishes a
        committed step for this reason)."""
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        aside = None
        if os.path.isdir(dst):
            aside = f"{dst}.old.{os.getpid()}"
            if self.is_exist(aside):
                shutil.rmtree(aside)
            os.replace(dst, aside)
        os.replace(src, dst)
        parent = os.path.dirname(os.path.abspath(dst)) or "."
        try:
            fd = os.open(parent, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass  # fsync on a directory is unsupported on some filesystems
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
