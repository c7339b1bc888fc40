"""Filesystem helpers: the port's copy of ``paddle_tpu/fs.py``
(:20-143), the ``FS`` interface, its errors and ``LocalFS`` (the
crash-safe ``atomic_rename`` that ``resilience.CheckpointPolicy``
commits through included). ``HDFSClient``, which drives the ``hadoop
fs`` command line, is ROADMAP A11 and refused by name."""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple

__all__ = ["FS", "LocalFS", "HDFSClient", "ExecuteError",
           "FSFileExistsError", "FSFileNotExistsError"]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def rename(self, src, dst):
        raise NotImplementedError

    def atomic_rename(self, src, dst):
        raise NotImplementedError


class LocalFS(FS):
    """Reference fs.cc localfs_* functions."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        """(dirs, files), the reference's split listing."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for e in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, e)) else files).append(e)
        return dirs, files

    def is_file(self, path) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path) -> bool:
        return os.path.isdir(path)

    def is_exist(self, path) -> bool:
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if self.is_dir(path):
            shutil.rmtree(path)
        elif self.is_file(path):
            os.remove(path)

    def rename(self, src, dst):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        os.replace(src, dst)

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

    def mv(self, src, dst, overwrite=False):
        if not overwrite and self.is_exist(dst):
            raise FSFileExistsError(dst)
        self.rename(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path) and not exist_ok:
            raise FSFileExistsError(path)
        open(path, "a").close()

    def cat(self, path) -> str:
        with open(path) as f:
            return f.read()

    def need_upload_download(self) -> bool:
        return False

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient(FS):
    """The reference's ``hadoop fs`` client: not ported (ROADMAP A11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "fs.HDFSClient is not ported to paddle_tpu_torch yet "
            "(ROADMAP A11); use LocalFS")
