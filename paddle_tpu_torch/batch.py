"""paddle.batch — reader decorator (counterpart of
``paddle_tpu/batch.py``; Paddle's python/paddle/batch.py).

Groups samples from a sample-level reader into lists of `batch_size`.
Kept for parity with legacy reader pipelines; new code should use
paddle_tpu_torch.io.DataLoader, which adds collation and prefetch.
"""

__all__ = ['batch']


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batch reader yielding lists."""
    if batch_size <= 0:
        raise ValueError(f'batch_size must be positive, got {batch_size}')

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader
