"""paddle.dataset.common — shared helpers of the fluid-era dataset stack.

Counterpart of ``paddle_tpu/dataset/common.py``; Paddle's
python/paddle/dataset/common.py (download:62, md5file:53, split:130,
cluster_files_reader:167).

Zero-egress build: download() never fetches; it returns the cache path
when the file is already there and raises with a pointer otherwise —
the per-dataset modules fall back to the synthetic corpora in
vision/text datasets instead of calling it.
"""
import glob
import hashlib
import os
import pickle

import numpy as np

__all__ = ['DATA_HOME', 'download', 'md5file', 'split',
           'cluster_files_reader']

DATA_HOME = os.path.expanduser('~/.cache/paddle/dataset')


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, 'rb') as f:
        for chunk in iter(lambda: f.read(4096), b''):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve the local cache path for a dataset file.  This build has
    no egress: if the file exists (pre-seeded) return it, else raise —
    callers in this package catch and serve synthetic data."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split('/')[-1])
    if os.path.exists(filename) and (
            not md5sum or md5file(filename) == md5sum):
        return filename
    raise RuntimeError(
        f'dataset file {filename} not present and this build cannot '
        f'download ({url}); place the file there or use the synthetic '
        'fallback readers')


def split(reader, line_count, suffix='%05d.pickle', dumper=None):
    """Spill a reader into numbered pickle chunks of line_count samples
    (reference common.py:130)."""
    if not callable(reader):
        raise TypeError('reader should be callable')
    if '%' not in suffix:
        raise ValueError('suffix must contain a printf format like %05d')
    dumper = dumper or pickle.dump
    lines = []
    indx_file = 0
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_file, 'wb') as f:
                dumper(lines, f)
            lines = []
            indx_file += 1
    if lines:
        with open(suffix % indx_file, 'wb') as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Round-robin a glob of spilled files across trainers (reference
    common.py:167)."""
    loader = loader or pickle.load

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_files = [f for i, f in enumerate(file_list)
                    if i % trainer_count == trainer_id]
        for fn in my_files:
            with open(fn, 'rb') as f:
                for item in loader(f):
                    yield item

    return reader


def _dataset_reader(ds, mapper=None):
    """Adapt a map-style io.Dataset into a fluid-era reader callable."""

    def reader():
        for i in range(len(ds)):
            sample = ds[i]
            yield mapper(sample) if mapper else sample

    return reader
