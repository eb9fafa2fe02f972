"""Filesystem clients (counterpart of
``paddle_tpu/distributed/fleet/utils/fs.py``): ``LocalFS`` on the local
disk, and ``HDFSClient``, which drives the ``hadoop`` binary as the
reference's does and raises at construction when no hadoop client is
installed, instead of failing at its first use.
"""
import os
import shutil
import subprocess

__all__ = ['LocalFS', 'HDFSClient']


class ExecuteError(Exception):
    pass


class LocalFS:
    """The local disk, the reference's API."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path)
        else:
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FileExistsError(fs_path)
            return
        open(fs_path, 'a').close()

    def mv(self, src_path, dst_path, overwrite=False):
        if not overwrite and self.is_exist(dst_path):
            raise FileExistsError(dst_path)
        shutil.move(src_path, dst_path)

    def list_dirs(self, fs_path):
        dirs, _ = self.ls_dir(fs_path)
        return dirs


class HDFSClient:
    """``hadoop fs -...`` subcommands, as the reference issues them; needs
    a hadoop client on PATH (or under ``hadoop_home``)."""

    def __init__(self, hadoop_home=None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self._hadoop = os.path.join(hadoop_home, 'bin', 'hadoop') \
            if hadoop_home else shutil.which('hadoop')
        if not self._hadoop or not os.path.exists(self._hadoop):
            raise RuntimeError(
                'HDFSClient needs a hadoop client binary (none found on '
                'PATH); use LocalFS, or distributed.checkpoint for model '
                'state')
        self._configs = [f'-D{k}={v}'
                         for k, v in (configs or {}).items()]
        self._timeout = time_out / 1000.0

    def _run(self, *args):
        cmd = [self._hadoop, 'fs', *self._configs, *args]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=self._timeout)
        if proc.returncode != 0:
            raise ExecuteError(f'{" ".join(cmd)}: {proc.stderr}')
        return proc.stdout

    def ls_dir(self, fs_path):
        out = self._run('-ls', fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith('d') else files).append(name)
        return dirs, files

    def is_exist(self, fs_path):
        try:
            self._run('-test', '-e', fs_path)
            return True
        except ExecuteError:
            return False

    def mkdirs(self, fs_path):
        self._run('-mkdir', '-p', fs_path)

    def delete(self, fs_path):
        self._run('-rm', '-r', fs_path)

    def upload(self, local_path, fs_path):
        self._run('-put', local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run('-get', fs_path, local_path)

    def need_upload_download(self):
        return True
