"""Filesystem helpers: the port's copy of ``paddle_tpu/fs.py``, the
``FS`` interface, its errors, ``LocalFS`` (the crash-safe
``atomic_rename`` that ``resilience.CheckpointPolicy`` commits through
included) and ``HDFSClient``, which drives the ``hadoop fs`` command
line and raises ``ExecuteError`` where there is no hadoop binary."""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import List, Optional, Tuple

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
    """Reference incubate/fleet/utils/hdfs.py:45: every operation is a
    ``hadoop fs -<cmd>`` subprocess with bounded retries."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self._hadoop_home = hadoop_home or os.environ.get("HADOOP_HOME", "")
        self._configs = configs or {}
        self._time_out = time_out
        self._sleep_inter = sleep_inter
        pre = []
        for k, v in self._configs.items():
            pre.append(f"-D{k}={v}")
        binpath = (
            os.path.join(self._hadoop_home, "bin", "hadoop")
            if self._hadoop_home else "hadoop"
        )
        self._base_cmd = [binpath, "fs"] + pre

    def _hadoop_available(self) -> bool:
        return shutil.which(self._base_cmd[0]) is not None

    def _cmd(self, *args) -> List[str]:
        return self._base_cmd + list(args)

    def _run(self, args, retry_times=5) -> Tuple[int, str]:
        """Reference __run_hdfs_cmd: retry transient failures."""
        if not self._hadoop_available():
            raise ExecuteError(
                f"hadoop binary not found ({self._base_cmd[0]!r}) — set "
                "hadoop_home or HADOOP_HOME, or use LocalFS"
            )
        last = ""
        for i in range(retry_times):
            try:
                proc = subprocess.run(
                    self._cmd(*args), capture_output=True, text=True,
                    timeout=self._time_out / 1000.0,
                )
                if proc.returncode == 0:
                    return 0, proc.stdout
                last = proc.stderr
            except subprocess.TimeoutExpired:
                last = f"timed out after {self._time_out}ms"
            if i < retry_times - 1:
                time.sleep(self._sleep_inter / 1000.0)
        raise ExecuteError(f"hadoop fs {' '.join(args)} failed: {last[-500:]}")

    # -- operations (each mirrors a reference method) -----------------------
    def is_exist(self, path) -> bool:
        try:
            self._run(["-test", "-e", path], retry_times=1)
            return True
        except ExecuteError as e:
            if "hadoop binary not found" in str(e):
                raise
            return False

    def is_dir(self, path) -> bool:
        try:
            self._run(["-test", "-d", path], retry_times=1)
            return True
        except ExecuteError as e:
            if "hadoop binary not found" in str(e):
                raise
            return False

    def is_file(self, path) -> bool:
        return self.is_exist(path) and not self.is_dir(path)

    def ls_dir(self, path):
        _, out = self._run(["-ls", path])
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1]
            (dirs if parts[0].startswith("d") else files).append(
                os.path.basename(name))
        return dirs, files

    def mkdirs(self, path):
        self._run(["-mkdir", "-p", path])

    def delete(self, path):
        self._run(["-rm", "-r", "-f", path])

    def rename(self, src, dst, overwrite=False):
        if overwrite:
            self._run(["-rm", "-r", "-f", dst])
        self._run(["-mv", src, dst])

    def atomic_rename(self, src, dst):
        raise NotImplementedError(
            "HDFSClient.atomic_rename: `hadoop fs -mv` gives no "
            "atomicity or durability guarantee when dst exists (it can "
            "move src INSIDE a dst directory), so it cannot implement "
            "the checkpoint commit protocol — write checkpoints to a "
            "LocalFS staging dir and upload() the committed result"
        )

    def cat(self, path) -> str:
        _, out = self._run(["-cat", path])
        return out

    def upload(self, hdfs_path, local_path, overwrite=False, retry_times=5):
        if overwrite:
            self._run(["-rm", "-r", "-f", hdfs_path], retry_times=1)
        self._run(["-put", local_path, hdfs_path], retry_times)

    def download(self, hdfs_path, local_path, overwrite=False, retry_times=5):
        if overwrite and os.path.exists(local_path):
            LocalFS().delete(local_path)
        self._run(["-get", hdfs_path, local_path], retry_times)

    def need_upload_download(self) -> bool:
        return True

    @staticmethod
    def split_files(files: List[str], trainer_id: int, trainers: int):
        """Reference hdfs.py:396 — contiguous file partition per
        trainer."""
        remainder = len(files) % trainers
        blocksize = len(files) // trainers
        blocks = [blocksize] * trainers
        for i in range(remainder):
            blocks[i] += 1
        trainer_files = [[]] * trainers
        begin = 0
        for i in range(trainers):
            trainer_files[i] = files[begin:begin + blocks[i]]
            begin += blocks[i]
        return trainer_files[trainer_id]
