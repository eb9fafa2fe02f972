"""MultiSlot data generators (counterpart of
``paddle_tpu/distributed/fleet/data_generator.py``): a subclass
implements ``generate_sample(line)`` yielding ``[(slot_name, values),
...]``, and ``run_from_stdin``/``run_from_memory`` turn raw lines into
the MultiSlot text format the dataset readers take (``<n> v1 .. vn`` a
slot, space-joined a sample line).
"""
import sys

__all__ = ['DataGenerator', 'MultiSlotDataGenerator',
           'MultiSlotStringDataGenerator']


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        """Override: return a generator yielding
        [(slot_name, [values]), ...] per sample derived from `line`."""
        raise NotImplementedError(
            'implement generate_sample(self, line) in your subclass')

    def generate_batch(self, samples):
        """Override for batch-level postprocessing; default passthrough."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _format_sample(self, sample):
        raise NotImplementedError

    def run_from_stdin(self):
        for line in sys.stdin:
            for sample in self._samples_of(line):
                sys.stdout.write(self._format_sample(sample) + '\n')

    def run_from_memory(self, lines):
        """Like run_from_stdin but over an iterable; returns the
        formatted lines (testable without process plumbing)."""
        out = []
        for line in lines:
            for sample in self._samples_of(line):
                out.append(self._format_sample(sample))
        return out

    def _samples_of(self, line):
        gen = self.generate_sample(line)
        if gen is None:
            return
        batch = []
        for sample in gen():
            batch.append(sample)
            if len(batch) == self.batch_size_:
                yield from self.generate_batch(batch)()
                batch = []
        if batch:
            yield from self.generate_batch(batch)()


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: each becomes `<n> v1 ... vn`."""

    def _format_sample(self, sample):
        parts = []
        for name, values in sample:
            values = list(values)
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return ' '.join(parts)


class MultiSlotStringDataGenerator(DataGenerator):
    """String slots: values pass through verbatim, no length prefix
    (reference MultiSlotStringDataGenerator)."""

    def _format_sample(self, sample):
        parts = []
        for name, values in sample:
            parts.extend(str(v) for v in values)
        return ' '.join(parts)
